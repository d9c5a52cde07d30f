"""Counterpart of anorag_tpu/llm/parallel_note_gen.py,
copied as it is with its imports renamed to anorag_tpu_torch.

Parallel atomic-note generation across LLM endpoints.

Parity targets:
  * ParallelTaskAtomicNoteGenerator
    (upstream llm/parallel_task_atomic_note_generator.py): splits
    chunk batches across two endpoint families (round_robin / batch_split
    allocation) with failure fallback to the surviving endpoint;
  * ParallelAtomicNoteGenerator
    (upstream parallel/parallel_atomic_note_generator.py:13-508):
    strategies fastest-wins, quality-selection, dual-validation,
    work-division.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Any, Dict, List, Optional, Sequence

from anorag_tpu_torch.llm.note_generator import AtomicNoteGenerator
from anorag_tpu_torch.utils.logging import get_logger

logger = get_logger("anorag.notes")


class ParallelTaskAtomicNoteGenerator:
    """Task-division: shard chunks across endpoints, fall back on failure."""

    def __init__(self, llms: Sequence[Any], cfg: Optional[Any] = None,
                 allocation_method: str = "round_robin", enable_fallback: bool = True,
                 max_workers: int = 4):
        assert llms, "need at least one endpoint"
        self.generators = [AtomicNoteGenerator(llm, cfg) for llm in llms]
        self.allocation_method = allocation_method
        self.enable_fallback = enable_fallback
        self.max_workers = max_workers
        self.stats = {"fallbacks": 0, "per_endpoint": [0] * len(llms)}

    def _allocate(self, chunks: Sequence[Dict[str, Any]]) -> List[List[int]]:
        n_ep = len(self.generators)
        alloc: List[List[int]] = [[] for _ in range(n_ep)]
        if self.allocation_method == "batch_split":
            size = max(1, (len(chunks) + n_ep - 1) // n_ep)
            for e in range(n_ep):
                alloc[e] = list(range(e * size, min((e + 1) * size, len(chunks))))
        else:  # round_robin
            for i in range(len(chunks)):
                alloc[i % n_ep].append(i)
        return alloc

    def generate_atomic_notes(self, chunks: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        chunks = list(chunks)
        alloc = self._allocate(chunks)
        results: Dict[int, List[Dict[str, Any]]] = {}

        def run(ep: int, idxs: List[int]) -> None:
            gen = self.generators[ep]
            for i in idxs:
                try:
                    results[i] = gen.generate_for_chunk(chunks[i])
                    self.stats["per_endpoint"][ep] += 1
                except Exception as e:
                    logger.warning("endpoint %d failed on chunk %d: %s", ep, i, e)
                    results[i] = None  # marked for fallback

        with ThreadPoolExecutor(max_workers=min(self.max_workers, len(self.generators))) as ex:
            futs = [ex.submit(run, ep, idxs) for ep, idxs in enumerate(alloc) if idxs]
            for f in as_completed(futs):
                f.result()

        if self.enable_fallback:
            for i, r in list(results.items()):
                if r is None:
                    for ep, gen in enumerate(self.generators):
                        try:
                            results[i] = gen.generate_for_chunk(chunks[i])
                            self.stats["fallbacks"] += 1
                            break
                        except Exception:
                            continue
        out: List[Dict[str, Any]] = []
        for i in range(len(chunks)):
            out.extend(results.get(i) or [])
        return out


def _note_quality_score(notes: List[Dict[str, Any]]) -> float:
    """Heuristic quality: count, entity coverage, length sanity."""
    if not notes:
        return 0.0
    with_entities = sum(1 for n in notes if n.get("entities"))
    len_ok = sum(1 for n in notes if 20 <= len(n.get("content") or "") <= 400)
    return len(notes) + 0.5 * with_entities + 0.25 * len_ok


class ParallelAtomicNoteGenerator:
    """Multi-endpoint strategies over the SAME chunks."""

    def __init__(self, llms: Sequence[Any], cfg: Optional[Any] = None,
                 strategy: str = "fastest_wins"):
        self.generators = [AtomicNoteGenerator(llm, cfg) for llm in llms]
        self.strategy = strategy

    def generate_atomic_notes(self, chunks: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
        if self.strategy == "work_division":
            return ParallelTaskAtomicNoteGenerator(
                [g.llm for g in self.generators], self.generators[0].cfg,
                allocation_method="batch_split",
            ).generate_atomic_notes(chunks)
        out: List[Dict[str, Any]] = []
        for chunk in chunks:
            out.extend(self._one_chunk(chunk))
        return out

    def _one_chunk(self, chunk: Dict[str, Any]) -> List[Dict[str, Any]]:
        if self.strategy == "fastest_wins":
            with ThreadPoolExecutor(max_workers=len(self.generators)) as ex:
                futs = [ex.submit(g.generate_for_chunk, chunk) for g in self.generators]
                for f in as_completed(futs):
                    try:
                        r = f.result()
                        if r:
                            return r
                    except Exception:
                        continue
            return []
        # quality_selection / dual_validation need all results
        all_results: List[List[Dict[str, Any]]] = []
        with ThreadPoolExecutor(max_workers=len(self.generators)) as ex:
            futs = [ex.submit(g.generate_for_chunk, chunk) for g in self.generators]
            for f in futs:
                try:
                    all_results.append(f.result())
                except Exception:
                    all_results.append([])
        if self.strategy == "dual_validation":
            return self._consistent_subset(all_results)
        return max(all_results, key=_note_quality_score)

    @staticmethod
    def _consistent_subset(all_results: List[List[Dict[str, Any]]]) -> List[Dict[str, Any]]:
        """Keep notes whose text is (loosely) corroborated by another
        endpoint; fall back to the best single result."""
        if len(all_results) < 2:
            return all_results[0] if all_results else []
        from anorag_tpu_torch.utils.text import tokenize_no_stop

        def sig(n):
            return frozenset(tokenize_no_stop(n.get("content") or ""))

        sigs = [ {sig(n) for n in r} for r in all_results ]
        kept = []
        for i, result in enumerate(all_results):
            others = set().union(*(sigs[:i] + sigs[i + 1:]))
            for n in result:
                s = sig(n)
                if any(len(s & o) / max(len(s | o), 1) >= 0.6 for o in others):
                    kept.append(n)
        if kept:
            seen, out = set(), []
            for n in kept:
                if n["note_id"] not in seen:
                    seen.add(n["note_id"])
                    out.append(n)
            return out
        return max(all_results, key=_note_quality_score)
