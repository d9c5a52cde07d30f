"""Scan a config YAML for deprecated and unknown keys (host only).

Counterpart of scripts/check_deprecated_config.py, with its argument,
printed report and exit code:

    python -m anorag_tpu_torch.check_deprecated_config CONFIG.yaml

The file is read with the port's own YAML reader (config/yaml_subset.py,
no PyYAML) and merged over the defaults by ConfigLoader; exit 1 when it
names an unknown or deprecated key.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from anorag_tpu_torch.config import ConfigLoader
from anorag_tpu_torch.config.yaml_subset import safe_load


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("config")
    args = ap.parse_args(argv)
    with open(args.config, encoding="utf-8") as fh:
        user = safe_load(fh) or {}
    loader = ConfigLoader(auto_load=False)
    loader.apply_overrides(user)
    print(json.dumps(loader.report(), indent=2))
    return 1 if (loader.unknown_keys or loader.deprecated_hits) else 0


if __name__ == "__main__":
    raise SystemExit(main())
