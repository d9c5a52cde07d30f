"""Counterpart of anorag_tpu/graph/exporter.py,
copied as it is with its imports renamed to anorag_tpu_torch.

GraphML export with attribute sanitization.

Parity target: upstream graph/graphml_exporter.py:7-179 and the
GraphIndex export (:114-155): node/edge attributes are flattened to
GraphML-legal scalar types (lists/dicts JSON-encoded, None dropped), and the
written file is verified by re-parsing.
"""
from __future__ import annotations

import json
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Any, Dict

from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.graph")

_TYPES = {str: "string", int: "long", float: "double", bool: "boolean"}


def _sanitize(value: Any):
    if value is None:
        return None
    if isinstance(value, (str, int, float, bool)):
        return value
    try:
        return json.dumps(value, ensure_ascii=False)
    except Exception:
        return str(value)


def export_graphml(graph_index, path: str | Path, verify: bool = True) -> bool:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    # collect attribute keys + types
    node_attrs: Dict[str, str] = {}
    nodes = []
    for n in graph_index.notes:
        clean = {}
        for k, v in n.items():
            sv = _sanitize(v)
            if sv is None:
                continue
            clean[k] = sv
            node_attrs.setdefault(k, _TYPES.get(type(sv), "string"))
        nodes.append(clean)
    edge_attrs = {"weight": "double", "relation_type": "string"}

    root = ET.Element("graphml", xmlns="http://graphml.graphdrawing.org/xmlns")
    for k, t in node_attrs.items():
        ET.SubElement(root, "key", id=f"n_{k}", **{"for": "node", "attr.name": k, "attr.type": t})
    for k, t in edge_attrs.items():
        ET.SubElement(root, "key", id=f"e_{k}", **{"for": "edge", "attr.name": k, "attr.type": t})
    g = ET.SubElement(root, "graph", id="G", edgedefault="undirected")
    for i, clean in enumerate(nodes):
        node_el = ET.SubElement(g, "node", id=str(clean.get("note_id", i)))
        for k, v in clean.items():
            d = ET.SubElement(node_el, "data", key=f"n_{k}")
            d.text = str(v)
    for r in graph_index.edge_meta:
        u = graph_index.notes[r["source"]].get("note_id")
        v = graph_index.notes[r["target"]].get("note_id")
        e = ET.SubElement(g, "edge", source=str(u), target=str(v))
        for k in edge_attrs:
            if k in r and r[k] is not None:
                d = ET.SubElement(e, "data", key=f"e_{k}")
                d.text = str(r[k])
    ET.ElementTree(root).write(path, encoding="utf-8", xml_declaration=True)

    if verify:
        try:
            ET.parse(path)
        except ET.ParseError as e:
            logger.error("graphml verification failed: %s", e)
            return False
    logger.info("exported graphml: %s (%d nodes, %d edges)",
                path, len(nodes), len(graph_index.edge_meta))
    return True
