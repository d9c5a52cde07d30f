"""Counterpart of anorag_tpu/doc/chunker.py,
copied as it is with its imports renamed to anorag_tpu_torch.

DocumentChunker: files/text -> paragraph-aware sentence chunks.

Parity target: upstream doc/chunker.py — reads json/jsonl/txt
(docx degrades to a warning), paragraph-preserving sentence-level chunking
(:251) with max-char budgets, paragraph_idx mapping (:726), optional
event-aware chunking (boundary extension around event cue sentences, :374),
and low-quality chunk filtering (:782-803).

Chunk contract (consumed by AtomicNoteGenerator): {doc_id, chunk_index,
title, text, sentences, sentence_ids, paragraph_idx, paragraph_idx_mapping}.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, List, Sequence, Tuple

from anorag_tpu_torch.utils.file_io import read_json, read_jsonl
from anorag_tpu_torch.utils.logging import get_logger
from anorag_tpu_torch.utils.text import split_paragraphs, split_sentences

logger = get_logger("anorag.doc")

# typed event families (ref chunker.py:11-30 event_keywords): the types
# drive the chain-relatedness rules below, not just cue detection
_EVENT_TYPES: Dict[str, "re.Pattern[str]"] = {
    "acquisition": re.compile(r"\b(acquired|acquisition|bought|purchased|took over)\b", re.I),
    "merger": re.compile(r"\b(merged|merger)\b", re.I),
    "ownership": re.compile(r"\b(owned|owner|ownership|belongs to|subsidiary)\b", re.I),
    "succession": re.compile(r"\b(succeeded|successor|replaced|inherited)\b", re.I),
    "bankruptcy": re.compile(r"\b(bankrupt|bankruptcy|insolvent|liquidat\w+)\b", re.I),
    "partnership": re.compile(r"\b(partner(?:ed|ship)?|joint venture|alliance)\b", re.I),
    "founding": re.compile(r"\b(founded|established|created|launched)\b", re.I),
    "life": re.compile(r"\b(married|died|born|divorced)\b", re.I),
    "career": re.compile(r"\b(elected|appointed|joined|left|resigned|won|moved)\b", re.I),
    "release": re.compile(r"\b(released|published|announced|premiered)\b", re.I),
}

# event-chain relatedness (ref chunker.py:544-562): same type, or a pair in
# this set, makes two event sentences part of one chain
_RELATED_PAIRS = {
    frozenset(p) for p in [
        ("acquisition", "ownership"), ("succession", "ownership"),
        ("merger", "acquisition"), ("bankruptcy", "acquisition"),
        ("partnership", "merger"), ("founding", "ownership"),
    ]
}


def _read_docx(path: Path) -> str:
    """Minimal OOXML paragraph extraction — a .docx is a zip whose
    word/document.xml holds <w:p> paragraphs of <w:t> text runs (ref
    doc/chunker.py reads docx via python-docx; stdlib-only here).
    Tabs and explicit line breaks become spaces; paragraphs join with
    blank lines so split_paragraphs sees the document structure."""
    import xml.etree.ElementTree as ET
    import zipfile

    ns = "{http://schemas.openxmlformats.org/wordprocessingml/2006/main}"
    with zipfile.ZipFile(path) as zf:
        with zf.open("word/document.xml") as fh:
            root = ET.parse(fh).getroot()
    paras: List[str] = []
    for p in root.iter(f"{ns}p"):
        runs: List[str] = []
        for node in p.iter():
            if node.tag == f"{ns}t":
                runs.append(node.text or "")
            elif node.tag in (f"{ns}tab", f"{ns}br", f"{ns}cr"):
                runs.append(" ")
        text = "".join(runs).strip()
        if text:
            paras.append(text)
    return "\n\n".join(paras)


class DocumentChunker:
    def __init__(self, max_chunk_chars: int = 512, overlap_chars: int = 0,
                 min_chunk_chars: int = 20, strategy: str = "sentence"):
        self.max_chunk_chars = max_chunk_chars
        self.overlap_chars = overlap_chars
        self.min_chunk_chars = min_chunk_chars
        self.strategy = strategy

    # ---------------------------------------------------------- file entry
    def chunk_file(self, path: str | Path) -> List[Dict[str, Any]]:
        path = Path(path)
        docs = self._load(path)
        out: List[Dict[str, Any]] = []
        for d in docs:
            out.extend(self.chunk_document(d))
        return out

    @staticmethod
    def _load(path: Path) -> List[Dict[str, Any]]:
        suffix = path.suffix.lower()
        if suffix == ".jsonl":
            return list(read_jsonl(path))
        if suffix == ".json":
            data = read_json(path)
            return data if isinstance(data, list) else [data]
        if suffix in (".txt", ".md"):
            text = path.read_text(encoding="utf-8")
            return [{"id": path.stem, "title": path.stem, "text": text}]
        if suffix == ".docx":
            text = _read_docx(path)
            return [{"id": path.stem, "title": path.stem, "text": text}]
        raise ValueError(f"unsupported document type: {path}")

    # ----------------------------------------------------------- doc entry
    def chunk_document(self, doc: Dict[str, Any]) -> List[Dict[str, Any]]:
        doc_id = str(doc.get("id") or doc.get("doc_id") or doc.get("_id") or "doc")
        title = str(doc.get("title") or "")
        paragraphs = self._paragraphs(doc)
        if not paragraphs:
            return []
        mapping = {i: p[:80] for i, (p, _) in enumerate(
            [(text, idx) for text, idx in paragraphs])}

        chunks: List[Dict[str, Any]] = []
        for text, pidx in paragraphs:
            if self.strategy == "event_aware":
                pieces = self._event_aware(text)
            else:
                pieces = [(p, {}) for p in self._sentence_pack(text)]
            for sents, meta in pieces:
                body = " ".join(sents)
                if len(body) < self.min_chunk_chars:
                    continue
                chunk = {
                    "doc_id": doc_id,
                    "chunk_index": len(chunks),
                    "title": title,
                    "text": body,
                    "sentences": sents,
                    "sentence_ids": list(range(len(sents))),
                    "paragraph_idx": pidx,
                    "paragraph_idx_mapping": mapping,
                    "source_info": {"file_name": doc.get("file_name", "")},
                }
                chunk.update(meta)
                chunks.append(chunk)
        return self._filter(chunks)

    def _paragraphs(self, doc: Dict[str, Any]) -> List[Tuple[str, int]]:
        """[(paragraph text, paragraph_idx)] — honors pre-split MuSiQue-style
        `paragraphs: [{idx, title, paragraph_text}]` payloads."""
        paras = doc.get("paragraphs")
        out: List[Tuple[str, int]] = []
        if isinstance(paras, list) and paras:
            for i, p in enumerate(paras):
                if isinstance(p, dict):
                    text = str(p.get("paragraph_text") or p.get("text") or "")
                    pt = str(p.get("title") or "")
                    idx = int(p.get("idx", i))
                    out.append(((f"{pt}. {text}" if pt else text).strip(), idx))
                else:
                    out.append((str(p), i))
            return [(t, i) for t, i in out if t]
        text = str(doc.get("text") or doc.get("content") or "")
        return [(p, i) for i, p in enumerate(split_paragraphs(text))]

    # ------------------------------------------------------------ packing
    def _sentence_pack(self, paragraph: str) -> List[List[str]]:
        """Greedy sentence packing under the char budget, with optional
        sentence-level overlap."""
        sents = split_sentences(paragraph)
        pieces: List[List[str]] = []
        cur: List[str] = []
        cur_len = 0
        for s in sents:
            if cur and cur_len + len(s) > self.max_chunk_chars:
                pieces.append(cur)
                if self.overlap_chars > 0:
                    # carry trailing sentences up to the overlap budget
                    keep, klen = [], 0
                    for t in reversed(cur):
                        if klen + len(t) > self.overlap_chars:
                            break
                        keep.insert(0, t)
                        klen += len(t)
                    cur, cur_len = keep, klen
                else:
                    cur, cur_len = [], 0
            cur.append(s)
            cur_len += len(s)
        if cur:
            pieces.append(cur)
        return pieces

    # --------------------------------------------------- event-aware chain
    # Full machinery (ref chunker.py:374-726): standard pieces -> boundary
    # optimization around event chains -> oversized-chunk split by event
    # proximity -> overlap merge. Pieces are SENTENCE-INDEX RANGES over the
    # paragraph, so boundary extension, overlap ratio, and merging are
    # exact interval operations instead of the reference's substring
    # searches (its text.find() misattributes repeated sentences).

    _EVENT_WINDOW = 5          # ~500 chars of context (ref :519 distance<=500)
    _GROUP_GAP = 2             # ~200 chars (ref :598 proximity grouping)
    _OVERSIZE = 1.5            # extension cap (ref :427 chunk_size*1.5)
    _MERGE_OVERLAP = 0.7       # overlap merge threshold (ref :623)

    @staticmethod
    def _identify_event_sentences(sents: Sequence[str]) -> List[Dict[str, Any]]:
        """[{index, types}] for sentences carrying event cues (ref :396)."""
        out = []
        for i, s in enumerate(sents):
            types = [t for t, pat in _EVENT_TYPES.items() if pat.search(s)]
            if types:
                out.append({"index": i, "types": types})
        return out

    @staticmethod
    def _events_related(types1: Sequence[str], types2: Sequence[str]) -> bool:
        for t1 in types1:
            for t2 in types2:
                if t1 == t2 or frozenset((t1, t2)) in _RELATED_PAIRS:
                    return True
        return False

    def _event_aware(self, paragraph: str) -> List[Tuple[List[str], Dict[str, Any]]]:
        sents = split_sentences(paragraph)
        events = self._identify_event_sentences(sents)
        base = self._sentence_pack(paragraph)
        if not events:
            return [(p, {}) for p in base]

        # base pieces as [lo, hi) sentence-index ranges
        ranges: List[List[int]] = []
        pos = 0
        for piece in base:
            ranges.append([pos, pos + len(piece)])
            pos += len(piece)
        lens = [len(s) for s in sents]

        def span_chars(lo: int, hi: int) -> int:
            return sum(lens[lo:hi]) + max(hi - lo - 1, 0)

        # boundary optimization: extend each event-bearing piece to cover
        # its related events within the window (ref :427-517)
        optimized: List[Tuple[List[int], Dict[str, Any]]] = []
        for lo, hi in ranges:
            inside = [e for e in events if lo <= e["index"] < hi]
            if not inside:
                optimized.append(([lo, hi], {}))
                continue
            related = list(inside)
            for e in inside:
                for other in events:
                    if other in related:
                        continue
                    if (abs(other["index"] - e["index"]) <= self._EVENT_WINDOW
                            and self._events_related(e["types"], other["types"])):
                        related.append(other)
            new_lo = min(lo, min(e["index"] for e in related))
            new_hi = max(hi, max(e["index"] for e in related) + 1)
            meta = {"event_chain_optimized": True,
                    "related_events": [e["types"] for e in related]}
            if span_chars(new_lo, new_hi) > self.max_chunk_chars * self._OVERSIZE:
                # split by event proximity groups, keeping chains whole
                # (ref :564-621)
                groups: List[List[Dict[str, Any]]] = []
                for e in sorted(related, key=lambda x: x["index"]):
                    if groups and e["index"] - groups[-1][-1]["index"] <= self._GROUP_GAP:
                        groups[-1].append(e)
                    else:
                        groups.append([e])
                cursor = new_lo
                for gi, g in enumerate(groups):
                    g_hi = (new_hi if gi == len(groups) - 1
                            else min(g[-1]["index"] + 1, new_hi))
                    if g_hi > cursor:
                        optimized.append(([cursor, g_hi], {
                            "event_chain_optimized": True,
                            "event_group": [e["types"] for e in g]}))
                    cursor = g_hi
            else:
                optimized.append(([new_lo, new_hi], meta))

        # overlap merge (ref :623-691): interval overlap over the shorter
        # range >= threshold -> union the ranges and the event metadata
        optimized.sort(key=lambda t: (t[0][0], t[0][1]))
        merged: List[Tuple[List[int], Dict[str, Any]]] = []
        for rng_, meta in optimized:
            if merged:
                prev, pmeta = merged[-1]
                inter = min(prev[1], rng_[1]) - max(prev[0], rng_[0])
                shorter = min(prev[1] - prev[0], rng_[1] - rng_[0])
                if shorter > 0 and inter / shorter >= self._MERGE_OVERLAP:
                    prev[0] = min(prev[0], rng_[0])
                    prev[1] = max(prev[1], rng_[1])
                    if meta.get("related_events") or meta.get("event_group"):
                        pmeta.setdefault("related_events", []).extend(
                            meta.get("related_events", meta.get("event_group", [])))
                        pmeta["event_chain_optimized"] = True
                    continue
            merged.append((rng_, dict(meta)))

        out: List[Tuple[List[str], Dict[str, Any]]] = []
        for (lo, hi), meta in merged:
            piece = sents[lo:hi]
            chain = bool(meta.get("event_chain_optimized"))
            # event-chain chunks stay whole past the budget (the reference's
            # merged chunks are never re-split, ref :623); only unoptimized
            # residue re-packs, and a 3x hard cap guards pathological chains
            cap = self.max_chunk_chars * (3.0 if chain else self._OVERSIZE)
            if span_chars(lo, hi) <= cap:
                out.append((piece, meta))
            else:
                out.extend((p, meta) for p in self._sentence_pack(" ".join(piece)))
        return out

    # ------------------------------------------------------------- filter
    def _filter(self, chunks: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        out = []
        for i, c in enumerate(chunks):
            text = c["text"]
            words = text.split()
            if len(text) < self.min_chunk_chars or len(words) < 3:
                continue
            alpha_ratio = sum(ch.isalnum() or ch.isspace() for ch in text) / max(len(text), 1)
            if alpha_ratio < 0.5:
                continue
            c["chunk_index"] = len(out)
            out.append(c)
        return out
