"""Counterpart of anorag_tpu/utils/file_io.py,
copied as it is with its imports renamed to anorag_tpu_torch.

File IO: json/jsonl/npz helpers, hashing, numbered work dirs.

Work-dir management reproduces the reference's per-run storage rewiring:
every entry point allocates `result/N/` and repoints `storage.*`
(upstream main.py:39-51, upstream main_musique.py:151-164).
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np


def read_json(path: str | Path) -> Any:
    with open(path, "r", encoding="utf-8") as fh:
        return json.load(fh)


def write_json(path: str | Path, obj: Any, indent: int = 2) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(obj, fh, ensure_ascii=False, indent=indent, default=_np_default)


def _np_default(o: Any) -> Any:
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


def read_jsonl(path: str | Path) -> List[Dict[str, Any]]:
    out = []
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def iter_jsonl(path: str | Path) -> Iterator[Dict[str, Any]]:
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                yield json.loads(line)


def write_jsonl(path: str | Path, rows: Iterable[Dict[str, Any]]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        for row in rows:
            fh.write(json.dumps(row, ensure_ascii=False, default=_np_default) + "\n")


def append_jsonl(path: str | Path, row: Dict[str, Any]) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(json.dumps(row, ensure_ascii=False, default=_np_default) + "\n")


def jsonl_sha1(rows: Iterable[Dict[str, Any]]) -> str:
    """SHA1 over JSONL serialization — the final-recall audit contract
    (upstream query/query_processor.py:2591-2619)."""
    h = hashlib.sha1()
    for row in rows:
        h.update((json.dumps(row, ensure_ascii=False, default=_np_default) + "\n").encode("utf-8"))
    return h.hexdigest()


def file_sha1(path: str | Path, chunk: int = 1 << 20) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as fh:
        while True:
            buf = fh.read(chunk)
            if not buf:
                break
            h.update(buf)
    return h.hexdigest()


def config_hash(cfg: Dict[str, Any]) -> str:
    """Stable hash of a config subtree, for artifact staleness checks."""
    blob = json.dumps(cfg, sort_keys=True, ensure_ascii=False, default=_np_default)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:16]


def save_array(path: str | Path, arr: np.ndarray) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.save(str(path), np.asarray(arr))


def load_array(path: str | Path) -> np.ndarray:
    return np.load(str(path), allow_pickle=False)


def next_work_dir(root: str | Path, create: bool = True) -> Path:
    """Allocate the next numbered `root/N` run directory."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    existing = [int(p.name) for p in root.iterdir() if p.is_dir() and p.name.isdigit()]
    n = (max(existing) + 1) if existing else 1
    work = root / str(n)
    if create:
        work.mkdir(parents=True, exist_ok=True)
    return work


def latest_work_dir(root: str | Path) -> Optional[Path]:
    root = Path(root)
    if not root.exists():
        return None
    dirs = sorted(
        (p for p in root.iterdir() if p.is_dir() and p.name.isdigit()),
        key=lambda p: int(p.name),
    )
    return dirs[-1] if dirs else None


def rewire_storage(cfg_loader: Any, work_dir: str | Path) -> Path:
    """Point all `storage.*` paths inside the given work dir."""
    work = Path(work_dir)
    work.mkdir(parents=True, exist_ok=True)
    cfg_loader.set("storage.work_dir", str(work))
    cfg_loader.set("storage.vector_index_path", str(work / "vector_index"))
    cfg_loader.set("storage.embedding_cache_path", str(work / "embedding_cache"))
    cfg_loader.set("storage.vector_store_path", str(work / "vector_store"))
    cfg_loader.set("storage.processed_docs_path", str(work / "processed_docs"))
    return work
