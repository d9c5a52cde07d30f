"""Counterpart of anorag_tpu/context/structure_pack.py,
copied as it is with its imports renamed to anorag_tpu_torch.

StructurePacker: answer-first structured evidence packing.

Parity target: upstream context/structure_pack.py:41-527 —
(1) pick the answer paragraph via QA coverage, (2) build a paragraph
similarity graph, (3) pick bridge paragraphs connecting the answer paragraph
to query entities (by graph path or similarity), (4) MMR sentence selection
inside the token budget, (5) reconstruct support idxs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from anorag_tpu_torch.reasoning.qa_coverage import QACoverageScorer
from anorag_tpu_torch.utils.text import estimate_tokens, split_sentences, tokenize_no_stop


def _tokset(text: str) -> set:
    return set(tokenize_no_stop(text))


class StructurePacker:
    def __init__(self, token_budget: int = 1800, max_bridges: int = 2,
                 mmr_lambda: float = 0.7, qa_scorer: Optional[QACoverageScorer] = None):
        self.token_budget = token_budget
        self.max_bridges = max_bridges
        self.mmr_lambda = mmr_lambda
        self.qa = qa_scorer or QACoverageScorer()

    def pack_evidence(self, notes: Sequence[Dict[str, Any]], query: str) -> Tuple[str, List[int]]:
        """Returns ([P{idx}]-tagged context, support idxs) — answer paragraph
        first, bridges next, sentence-MMR for the remainder."""
        paras = self._paragraphs(notes)
        if not paras:
            return "", []
        texts = [p["text"] for p in paras]
        # (1) answer paragraph
        answer_i = (self.qa.best_paragraphs(query, texts, top_k=1) or [0])[0]
        # (2)+(3) bridge paragraphs via similarity to both query and answer para
        sims = self._similarity_matrix(texts)
        q_toks = _tokset(query)
        q_sim = np.array([len(q_toks & _tokset(t)) / max(len(q_toks), 1) for t in texts])
        bridge_score = 0.5 * sims[answer_i] + 0.5 * q_sim
        bridge_score[answer_i] = -1
        bridges = list(np.argsort(-bridge_score)[: self.max_bridges])
        ordered = [answer_i] + [int(b) for b in bridges if bridge_score[b] > 0]
        # (4) MMR sentence fill within budget
        lines, support = [], []
        budget = self.token_budget
        for pi in ordered:
            p = paras[pi]
            chosen = self._mmr_sentences(query, p["text"], budget)
            if not chosen:
                continue
            tag = f"[P{p['idx']}]" if p["idx"] >= 0 else ""
            line = f"{tag} {p['title']}: {' '.join(chosen)}".strip()
            cost = estimate_tokens(line)
            if cost > budget:
                continue
            budget -= cost
            lines.append(line)
            if p["idx"] >= 0 and p["idx"] not in support:
                support.append(p["idx"])
        return "\n".join(lines), support

    # ------------------------------------------------------------ helpers
    @staticmethod
    def _paragraphs(notes: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        by_idx: Dict[int, Dict[str, Any]] = {}
        for n in notes:
            idxs = n.get("paragraph_idxs") or [-1]
            pidx = int(idxs[0])
            body = n.get("raw_span") or n.get("content") or ""
            if pidx in by_idx:
                if body not in by_idx[pidx]["text"]:
                    by_idx[pidx]["text"] += " " + body
            else:
                by_idx[pidx] = {"idx": pidx, "title": n.get("title") or "", "text": body}
        return list(by_idx.values())

    @staticmethod
    def _similarity_matrix(texts: List[str]) -> np.ndarray:
        toks = [_tokset(t) for t in texts]
        n = len(texts)
        sims = np.zeros((n, n), np.float32)
        for i in range(n):
            for j in range(i + 1, n):
                u = len(toks[i] | toks[j])
                s = len(toks[i] & toks[j]) / u if u else 0.0
                sims[i, j] = sims[j, i] = s
        return sims

    def _mmr_sentences(self, query: str, text: str, budget: int) -> List[str]:
        sents = split_sentences(text)
        if not sents:
            return []
        q_toks = _tokset(query)
        rel = [len(q_toks & _tokset(s)) / max(len(q_toks), 1) for s in sents]
        chosen: List[int] = []
        remaining = budget
        while len(chosen) < len(sents):
            best_i, best_v = -1, -np.inf
            for i in range(len(sents)):
                if i in chosen or estimate_tokens(sents[i]) > remaining:
                    continue
                red = max(
                    (len(_tokset(sents[i]) & _tokset(sents[j])) / max(len(_tokset(sents[i])), 1)
                     for j in chosen),
                    default=0.0,
                )
                v = self.mmr_lambda * rel[i] - (1 - self.mmr_lambda) * red
                if v > best_v:
                    best_v, best_i = v, i
            if best_i < 0 or (chosen and best_v <= 0):
                break
            chosen.append(best_i)
            remaining -= estimate_tokens(sents[best_i])
        return [sents[i] for i in sorted(chosen)]
