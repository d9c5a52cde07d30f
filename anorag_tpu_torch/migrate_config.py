"""Migrate a legacy config YAML onto the current skeleton (host only).

Counterpart of scripts/migrate_config.py, with its arguments and printed
lines:

    python -m anorag_tpu_torch.migrate_config INPUT.yaml OUTPUT.yaml

Deprecated keys are copied to their replacements (where those are unset),
unknown keys reported and kept, and the tree written back in its own key
order. The port reads and writes YAML with its own module
(config/yaml_subset.py: safe_load and safe_dump), where the root script
uses PyYAML: the file it writes can differ in layout and quoting, and
loads to the same tree.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

from anorag_tpu_torch.config import ConfigLoader, get_path, set_path
from anorag_tpu_torch.config.defaults import DEPRECATED_KEYS
from anorag_tpu_torch.config.yaml_subset import safe_dump, safe_load


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output")
    args = ap.parse_args(argv)

    with open(args.input, encoding="utf-8") as fh:
        user = safe_load(fh) or {}

    for old, new in DEPRECATED_KEYS.items():
        val = get_path(user, old)
        if val is not None and get_path(user, new) is None:
            set_path(user, new, val)
            print(f"migrated: {old} -> {new}")

    loader = ConfigLoader(auto_load=False)
    loader.apply_overrides(user)
    for key in loader.unknown_keys:
        print(f"unknown key (kept as-is, check spelling): {key}")

    with open(args.output, "w", encoding="utf-8") as fh:
        fh.write(safe_dump(user))
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
