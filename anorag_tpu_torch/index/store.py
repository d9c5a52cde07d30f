"""Counterpart of anorag_tpu/index/store.py, copied with its imports
renamed to anorag_tpu_torch: the manifests stamp the port's __version__,
which is held equal to the reference's.

Artifact store: versioned on-disk index artifacts with config-hash
staleness.

The reference checkpoints its pipeline as per-step cached files with
staleness checks (upstream doc/document_processor.py:98-196,
upstream vector_store/rebuild_vector_index.py:88-126). Here every
artifact (embedding shards, centroids, CSR graph, postings) is written with
a manifest {config_hash, input_hash, created_at, schema_version}; a load is
a hit only when both hashes match.
"""
from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np

import anorag_tpu_torch
from anorag_tpu_torch.utils.file_io import config_hash, read_json, write_json
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.store")

# bump SCHEMA_VERSION when artifact formats change; the package version is
# also stamped so artifacts built by older code rebuild automatically
SCHEMA_VERSION = 1


class ArtifactStore:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _manifest_path(self, name: str) -> Path:
        return self.root / f"{name}.manifest.json"

    def is_fresh(self, name: str, cfg: Dict[str, Any], input_hash: str = "") -> bool:
        mp = self._manifest_path(name)
        if not mp.exists():
            return False
        try:
            m = read_json(mp)
        except Exception:
            return False
        return (
            m.get("schema_version") == SCHEMA_VERSION
            and m.get("code_version") == anorag_tpu_torch.__version__
            and m.get("config_hash") == config_hash(cfg)
            and m.get("input_hash") == input_hash
        )

    def write_manifest(self, name: str, cfg: Dict[str, Any], input_hash: str = "",
                       extra: Optional[Dict[str, Any]] = None) -> None:
        write_json(
            self._manifest_path(name),
            {
                "schema_version": SCHEMA_VERSION,
                "code_version": anorag_tpu_torch.__version__,
                "config_hash": config_hash(cfg),
                "input_hash": input_hash,
                "created_at": time.time(),
                **(extra or {}),
            },
        )

    # typed helpers -------------------------------------------------------
    def save_arrays(self, name: str, cfg: Dict[str, Any], input_hash: str = "",
                    **arrays: np.ndarray) -> None:
        np.savez_compressed(self.root / f"{name}.npz", **arrays)
        self.write_manifest(name, cfg, input_hash, extra={"arrays": sorted(arrays)})

    def load_arrays(self, name: str) -> Dict[str, np.ndarray]:
        with np.load(self.root / f"{name}.npz", allow_pickle=False) as z:
            return {k: z[k] for k in z.files}

    def save_json(self, name: str, obj: Any, cfg: Dict[str, Any], input_hash: str = "") -> None:
        write_json(self.root / f"{name}.json", obj)
        self.write_manifest(name, cfg, input_hash)

    def load_json(self, name: str) -> Any:
        return read_json(self.root / f"{name}.json")

    def cached(self, name: str, cfg: Dict[str, Any], input_hash: str,
               build: Callable[[], Any], save: Callable[[Any], None],
               load: Callable[[], Any], force: bool = False) -> Any:
        """Generic build-or-load with staleness check; force = rebuild
        regardless of freshness (CLI --force, ref main.py:283)."""
        if not force and self.is_fresh(name, cfg, input_hash):
            try:
                obj = load()
                logger.info("artifact %s: cache hit", name)
                return obj
            except Exception as e:
                logger.warning("artifact %s: load failed (%s); rebuilding", name, e)
        obj = build()
        save(obj)
        self.write_manifest(name, cfg, input_hash)
        return obj
