"""Counterpart of anorag_tpu/doc/consistency.py,
copied as it is with its imports renamed to anorag_tpu_torch.

ConsistencyChecker: end-of-pipeline artifact gate.

Parity target: upstream utils/consistency_checker.py:15-360 — after
the offline pipeline, verify the artifacts agree: every note has the schema
fields, note counts match embeddings rows, graph nodes reference existing
notes, cluster labels cover all notes, paragraph idxs resolve.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from anorag_tpu_torch.validators.note_validator import validate_note


class ConsistencyChecker:
    def check_consistency(
        self,
        atomic_notes: Sequence[Dict[str, Any]],
        embeddings: Optional[np.ndarray] = None,
        graph_data: Optional[Dict[str, Any]] = None,
        clustering: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        issues: List[str] = []
        note_ids = set()
        for i, n in enumerate(atomic_notes):
            ok, note_issues = validate_note(n)
            if not ok:
                issues.append(f"note[{i}] ({n.get('note_id')}): {'; '.join(note_issues)}")
            nid = n.get("note_id")
            if nid in note_ids:
                issues.append(f"duplicate note_id: {nid}")
            note_ids.add(nid)

        if embeddings is not None and len(embeddings) != len(atomic_notes):
            issues.append(
                f"embedding rows ({len(embeddings)}) != notes ({len(atomic_notes)})"
            )
        if graph_data is not None:
            g_ids = {node.get("id") for node in graph_data.get("nodes", [])}
            orphans = g_ids - note_ids
            if orphans:
                issues.append(f"graph nodes not in notes: {sorted(orphans)[:5]}")
            for l in graph_data.get("links", []):
                if l.get("source") not in g_ids or l.get("target") not in g_ids:
                    issues.append(f"dangling edge: {l.get('source')} -> {l.get('target')}")
                    break
        if clustering is not None:
            labels = clustering.get("labels", [])
            if labels and len(labels) != len(atomic_notes):
                issues.append(f"cluster labels ({len(labels)}) != notes ({len(atomic_notes)})")

        return {
            "consistent": not issues,
            "n_notes": len(atomic_notes),
            "issues": issues[:50],
            "n_issues": len(issues),
        }
