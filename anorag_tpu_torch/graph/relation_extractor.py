"""Relation extraction: typed, weighted note-note edges.

Counterpart of anorag_tpu/graph/relation_extractor.py, copied with its
imports renamed, except for the constructor, which takes the device the
semantic-similarity pass runs on (keyword only), and
_semantic_similarity (:194-226). That pass keeps the reference's rule:
numpy's exact top-k (dense_topk_np) on the CPU or at 20,000 notes or
fewer, otherwise the streaming top-k kernel (dense_topk(...,
method="kernel"), csrc/streaming_topk.cu) on unit f32 rows on the card,
each note a query against the whole corpus, in chunks of
SEMANTIC_QUERY_CHUNK queries, so no N x N similarity matrix forms. The
rows stay f32: bf16 or TF32 products would move cosines across the 0.7
threshold.

Parity target: upstream graph/relation_extractor.py — the seven
rule-based extractors (reference :390, entity co-occurrence :418,
source-context :483, topic :543, semantic similarity :591, personal :631,
lightweight business :947), the relation type -> (weight, reasoning_value)
table (:36-57), and dedup/filter/per-note caps (:793-894).
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.ops.topk import dense_topk, dense_topk_np
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.graph")

# the host route's limits (the reference's): at most this many notes, or
# any number on the CPU while the (N, N) f32 scores take at most 2 GiB
SEMANTIC_HOST_ROWS = 20_000
# queries of one streaming top-k launch in the device route
SEMANTIC_QUERY_CHUNK = 32_768

# relation type -> (edge weight, reasoning value)
RELATION_TYPES: Dict[str, Tuple[float, float]] = {
    "reference": (1.0, 0.4),
    "entity_coexistence": (0.8, 0.3),
    "context": (0.6, 0.5),
    "topic": (0.7, 0.4),
    "semantic_similarity": (0.5, 0.6),
    "personal": (0.9, 0.3),
    "causal": (0.9, 1.0),
    "temporal": (0.8, 0.8),
    "definition": (0.7, 0.7),
    "comparison": (0.6, 0.6),
    "elaboration": (0.5, 0.5),
    "contradiction": (0.8, 0.9),
    "succession": (0.85, 0.9),
    "acquisition": (0.9, 0.95),
    "ownership": (0.8, 0.8),
    "subsidiary": (0.75, 0.7),
    "partnership": (0.7, 0.6),
    "merger": (0.9, 0.95),
}
RELATION_TYPE_IDS = {name: i for i, name in enumerate(RELATION_TYPES)}

_BUSINESS_PATTERNS = {
    "succession": r"\bsucceed(?:ed|s)?\b|\bsuccessor\b|\breplaced\b",
    "acquisition": r"\bacquir(?:e|ed|es|ing)\b|\bbought\b|\bpurchased\b",
    "ownership": r"\bown(?:s|ed|ership)?\b|\bbelongs? to\b",
    "subsidiary": r"\bsubsidiary\b|\bdivision of\b|\bunit of\b",
    "partnership": r"\bpartner(?:ship|ed)?\b|\bcollaborat(?:e|ed|ion)\b|\bjoint venture\b",
    "merger": r"\bmerg(?:e|ed|er|ing)\b",
}
_PERSONAL_PATTERN = re.compile(
    r"\bspouse\b|\bmarried\b|\bwife\b|\bhusband\b|\bfather\b|\bmother\b|\bson\b|"
    r"\bdaughter\b|\bbrother\b|\bsister\b|\bpartner\b", re.IGNORECASE,
)


class RelationExtractor:
    def __init__(
        self,
        semantic_threshold: float = 0.7,
        max_semantic_edges_per_note: int = 5,
        max_edges_per_note: int = 20,
        weights: Optional[Dict[str, float]] = None,
        llm=None,
        llm_window: int = 10,
        llm_batch_cap: int = 2000,
        *,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.semantic_threshold = semantic_threshold
        self.max_semantic_edges = max_semantic_edges_per_note
        self.max_edges_per_note = max_edges_per_note
        self.weights = {k: (weights or {}).get(k, w) for k, (w, _) in RELATION_TYPES.items()}
        # optional LLM pairwise window (ref graph/relation_extractor.py:
        # 186-238): each note is compared against the next `llm_window`
        # notes; the LLM names a typed relation or none. Off unless an llm
        # is supplied (enhanced_relation_extraction.use_llm_extraction).
        self.llm = llm
        self.llm_window = llm_window
        self.llm_batch_cap = llm_batch_cap

    # ----------------------------------------------------------- extractors
    def extract_all_relations(
        self,
        notes: Sequence[Dict[str, Any]],
        embeddings: Optional[np.ndarray] = None,
        topic_groups: Optional[Sequence[Sequence[str]]] = None,
    ) -> List[Dict[str, Any]]:
        if not notes:
            return []
        relations: List[Dict[str, Any]] = []
        relations += self._reference_relations(notes)
        relations += self._entity_cooccurrence(notes)
        relations += self._source_context(notes)
        if topic_groups:
            relations += self._topic_relations(notes, topic_groups)
        if embeddings is not None and len(embeddings) == len(notes):
            relations += self._semantic_similarity(notes, embeddings)
        relations += self._personal_relations(notes)
        relations += self._business_relations(notes)
        if self.llm is not None:
            relations += self._llm_semantic_relations(notes)
        relations = self._dedup_and_cap(relations)
        logger.info("extracted %d relations from %d notes", len(relations), len(notes))
        return relations

    def _rel(self, src: int, dst: int, rtype: str, extra: float = 0.0, **meta) -> Dict[str, Any]:
        w, rv = RELATION_TYPES[rtype]
        return {
            "source": src,
            "target": dst,
            "relation_type": rtype,
            "weight": self.weights.get(rtype, w) + extra,
            "reasoning_value": rv,
            **meta,
        }

    def _reference_relations(self, notes) -> List[Dict[str, Any]]:
        """note i's text mentions note j's title.

        Exact substring semantics, near-linear: titles are bucketed by
        their first 4 chars; a text only substring-checks titles whose
        bucket key appears among its 4-grams. (The naive N x N `t in text`
        sweep measured 10.3 s at 10k notes — 100M substring searches.)
        """
        out = []
        by_prefix: Dict[str, List[Tuple[int, str]]] = defaultdict(list)
        for j, n in enumerate(notes):
            t = (n.get("title") or "").strip().lower()
            if len(t) >= 4:
                by_prefix[t[:4]].append((j, t))
        for i, n in enumerate(notes):
            text = (n.get("content") or "").lower()
            if len(text) < 4:
                continue
            own = (n.get("title") or "").strip().lower()
            grams = {text[p:p + 4] for p in range(len(text) - 3)}
            for g in grams:
                for j, t in by_prefix.get(g, ()):
                    if j != i and t != own and t in text:
                        out.append(self._rel(i, j, "reference"))
        return out

    def _entity_cooccurrence(self, notes) -> List[Dict[str, Any]]:
        """shared entities => edge; weight scaled by overlap count."""
        by_entity: Dict[str, List[int]] = defaultdict(list)
        for i, n in enumerate(notes):
            for e in set(str(x).lower() for x in (n.get("entities") or [])):
                by_entity[e].append(i)
        pair_count: Dict[Tuple[int, int], int] = defaultdict(int)
        for ids in by_entity.values():
            if len(ids) < 2 or len(ids) > 50:   # skip hub entities
                continue
            for a in range(len(ids)):
                for b in range(a + 1, len(ids)):
                    pair_count[(ids[a], ids[b])] += 1
        return [
            self._rel(i, j, "entity_coexistence", extra=0.05 * min(c - 1, 4),
                      shared_entities=c)
            for (i, j), c in pair_count.items()
        ]

    def _source_context(self, notes) -> List[Dict[str, Any]]:
        """same doc, adjacent paragraph indices."""
        by_doc: Dict[str, List[int]] = defaultdict(list)
        for i, n in enumerate(notes):
            by_doc[str(n.get("doc_id"))].append(i)
        out = []
        for ids in by_doc.values():
            for a in range(len(ids)):
                for b in range(a + 1, len(ids)):
                    pa = notes[ids[a]].get("paragraph_idxs") or []
                    pb = notes[ids[b]].get("paragraph_idxs") or []
                    if pa and pb and min(abs(x - y) for x in pa for y in pb) <= 1:
                        out.append(self._rel(ids[a], ids[b], "context"))
        return out

    def _topic_relations(self, notes, topic_groups) -> List[Dict[str, Any]]:
        id_to_idx = {n.get("note_id"): i for i, n in enumerate(notes)}
        out = []
        for group in topic_groups:
            idxs = [id_to_idx[g] for g in group if g in id_to_idx]
            for a in range(len(idxs)):
                for b in range(a + 1, min(len(idxs), a + 6)):  # cap fan-out per group
                    out.append(self._rel(idxs[a], idxs[b], "topic"))
        return out

    def _semantic_similarity(self, notes, embeddings) -> List[Dict[str, Any]]:
        """top-k nearest neighbors per note above threshold — the streaming
        top-k kernel replaces the reference's dense N x N similarity
        matrix. `embeddings` is numpy or a tensor."""
        k = min(self.max_semantic_edges + 1, len(notes))
        if self._host_route(len(notes)):
            if isinstance(embeddings, torch.Tensor):
                embeddings = embeddings.float().cpu().numpy()
            emb = np.asarray(embeddings, np.float32)
            norms = np.linalg.norm(emb, axis=1, keepdims=True)
            emb = emb / np.maximum(norms, 1e-9)
            vals, idx = dense_topk_np(emb, emb, k)
        else:
            vals, idx = self._device_topk(embeddings, k)
        out = []
        for i in range(len(notes)):
            for r in range(vals.shape[1]):
                j = int(idx[i, r])
                s = float(vals[i, r])
                if j == i or j < 0 or s < self.semantic_threshold:
                    continue
                if j > i:  # undirected: emit once
                    out.append(self._rel(i, j, "semantic_similarity",
                                         extra=0.2 * (s - self.semantic_threshold),
                                         similarity=s))
        return out

    def _host_route(self, n: int) -> bool:
        """The reference's rule: numpy below SEMANTIC_HOST_ROWS notes, or on
        the CPU, while the (N, N) f32 scores fit in 2 GiB."""
        return 4 * n ** 2 <= 2 * 1024**3 and (
            self.device.type == "cpu" or n <= SEMANTIC_HOST_ROWS)

    def _device_topk(self, embeddings, k: int):
        """Exact top-k of the unit f32 rows against themselves on
        self.device, SEMANTIC_QUERY_CHUNK queries a launch of the
        streaming top-k kernel (its plain version on the CPU); numpy
        (N, k) values and rows."""
        emb = torch.as_tensor(embeddings).to(self.device, torch.float32)
        norms = torch.linalg.vector_norm(emb, dim=1, keepdim=True)
        emb = (emb / norms.clamp_min(1e-9)).contiguous()
        vals, idx = [], []
        for lo in range(0, emb.shape[0], SEMANTIC_QUERY_CHUNK):
            v, i = dense_topk(emb, emb[lo:lo + SEMANTIC_QUERY_CHUNK], k,
                              method="kernel")
            vals.append(v.cpu())
            idx.append(i.cpu())
        return torch.cat(vals).numpy(), torch.cat(idx).numpy()

    def _personal_relations(self, notes) -> List[Dict[str, Any]]:
        """notes sharing a person entity where either text has a personal cue."""
        person_notes: Dict[str, List[int]] = defaultdict(list)
        for i, n in enumerate(notes):
            for e in n.get("entities") or []:
                e = str(e)
                if e and e[0].isupper() and " " in e:   # crude person-shaped entity
                    person_notes[e.lower()].append(i)
        out = []
        for ids in person_notes.values():
            if len(ids) < 2 or len(ids) > 20:
                continue
            for a in range(len(ids)):
                for b in range(a + 1, len(ids)):
                    ta = notes[ids[a]].get("content") or ""
                    tb = notes[ids[b]].get("content") or ""
                    if _PERSONAL_PATTERN.search(ta) or _PERSONAL_PATTERN.search(tb):
                        out.append(self._rel(ids[a], ids[b], "personal"))
        return out

    def _business_relations(self, notes) -> List[Dict[str, Any]]:
        tagged: Dict[str, List[int]] = defaultdict(list)
        for i, n in enumerate(notes):
            text = (n.get("content") or "").lower()
            for rtype, pat in _BUSINESS_PATTERNS.items():
                if re.search(pat, text):
                    tagged[rtype].append(i)
        out = []
        for rtype, ids in tagged.items():
            ent_sets = {
                i: set(str(e).lower() for e in (notes[i].get("entities") or [])) for i in ids
            }
            for a in range(len(ids)):
                for b in range(a + 1, len(ids)):
                    if ent_sets[ids[a]] & ent_sets[ids[b]]:
                        out.append(self._rel(ids[a], ids[b], rtype))
        return out

    def _llm_semantic_relations(self, notes) -> List[Dict[str, Any]]:
        """LLM pairwise relation window (ref :186-238): each note pairs
        with the next `llm_window` notes; the LLM answers with a typed
        relation + confidence or 'none'. Unknown types and failed calls
        are skipped; total pairs capped at llm_batch_cap."""
        from anorag_tpu_torch.utils.json_parser import extract_json

        pairs = []
        for i in range(len(notes)):
            for j in range(i + 1, min(i + 1 + self.llm_window, len(notes))):
                pairs.append((i, j))
                if len(pairs) >= self.llm_batch_cap:
                    break
            if len(pairs) >= self.llm_batch_cap:
                logger.info("llm relation window capped at %d pairs", len(pairs))
                break
        out = []
        allowed = ", ".join(sorted(RELATION_TYPES))
        for i, j in pairs:
            a = (notes[i].get("content") or "")[:400]
            b = (notes[j].get("content") or "")[:400]
            prompt = (
                "Decide whether note B relates to note A with one of these "
                f"relation types: {allowed}. Respond ONLY with JSON "
                '{"relation_type": "<type or none>", "confidence": 0.0-1.0}.\n'
                f"Note A: {a}\nNote B: {b}"
            )
            try:
                raw = self.llm.generate(prompt, max_tokens=80, temperature=0.1)
            except Exception as e:
                logger.debug("llm relation call failed for (%d, %d): %s", i, j, e)
                continue
            parsed = extract_json(raw or "")
            if not isinstance(parsed, dict):
                continue
            rtype = str(parsed.get("relation_type") or "").strip().lower()
            if rtype not in RELATION_TYPES:
                continue
            try:
                conf = float(parsed.get("confidence", 0.5))
            except (TypeError, ValueError):
                conf = 0.5
            if conf < 0.3:
                continue
            out.append(self._rel(i, j, rtype,
                                 extra=0.2 * (min(max(conf, 0.0), 1.0) - 0.5),
                                 llm_confidence=conf))
        logger.info("llm pairwise window: %d relations from %d pairs",
                    len(out), len(pairs))
        return out

    # ----------------------------------------------------------- filtering
    def _dedup_and_cap(self, relations: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        """Keep the strongest edge per (u, v) pair; cap per-note degree,
        dropping weakest edges first (reference :793-894)."""
        best: Dict[Tuple[int, int], Dict[str, Any]] = {}
        for r in relations:
            u, v = sorted((r["source"], r["target"]))
            if u == v:
                continue
            key = (u, v)
            if key not in best or r["weight"] > best[key]["weight"]:
                best[key] = r
        edges = sorted(best.values(), key=lambda r: -r["weight"])
        degree: Dict[int, int] = defaultdict(int)
        kept = []
        for r in edges:
            u, v = r["source"], r["target"]
            if degree[u] >= self.max_edges_per_note or degree[v] >= self.max_edges_per_note:
                continue
            degree[u] += 1
            degree[v] += 1
            kept.append(r)
        return kept
