"""Counterpart of anorag_tpu/answer/evidence_rerank.py,
copied as it is with its imports renamed to anorag_tpu_torch.

EvidenceReranker: deterministic token-cue reranking of selected notes.

Parity target: upstream pipeline/evidence_rerank.py:12-100 with the
`evidence_rerank` config block (config.yaml:80-90): album-token bonus
(w_album), song/single/film-token penalty (w_song), supporting-flag bonus
(w_supporting), and the query-performer-asks-for-album cue
(w_q_performer_album).
"""
from __future__ import annotations

from typing import Any, Dict, List


class EvidenceReranker:
    def __init__(self, cfg: Dict[str, Any] | None = None):
        cfg = cfg or {}
        self.enable = cfg.get("enable", True)
        self.w_album = cfg.get("w_album", 0.5)
        self.w_song = cfg.get("w_song", -0.3)
        self.w_supporting = cfg.get("w_supporting", 0.4)
        self.w_q_performer_album = cfg.get("w_q_performer_album", 0.3)
        self.album_tokens = [t.lower() for t in cfg.get("album_tokens", ["(album)", " album"])]
        self.song_tokens = [t.lower() for t in cfg.get("song_tokens", ["(song)", " single", "(film)"])]
        self.support_flag_keys = cfg.get("support_flag_keys", ["is_supporting", "supporting"])
        self.query_performer_terms = [
            t.lower() for t in cfg.get("query_performer_terms", ["performer", "singer", "vocalist"])
        ]
        self.query_album_terms = [
            t.lower() for t in cfg.get("query_album_terms", ["album", "record", "ep"])
        ]

    def rerank(self, notes: List[Dict[str, Any]], query: str = "") -> List[Dict[str, Any]]:
        if not self.enable or not notes:
            return list(notes)
        q = (query or "").lower()
        q_perf_album = (
            any(t in q for t in self.query_performer_terms)
            and any(t in q for t in self.query_album_terms)
        )
        out = []
        for n in notes:
            m = dict(n)
            title = (m.get("title") or "").lower()
            bonus = 0.0
            is_album = any(t in title for t in self.album_tokens)
            if is_album:
                bonus += self.w_album
            if any(t in title for t in self.song_tokens):
                bonus += self.w_song
            if any(m.get(k) for k in self.support_flag_keys):
                bonus += self.w_supporting
            if q_perf_album and is_album:
                bonus += self.w_q_performer_album
            m["final_score"] = float(m.get("final_score", 0.0)) + bonus
            m["evidence_rerank_bonus"] = bonus
            out.append(m)
        out.sort(key=lambda x: -x["final_score"])
        return out
