"""The multichip dry run: every multi-device path once, at tiny shapes, over
a mesh of n devices.

Counterpart of the repo's __graft_entry__.dryrun_multichip (:49-275), with
its five parts, shapes and summary line:
  1. the encoder's dp x tp InfoNCE train step (models/encoder.py's
     ShardedEncoder, adamw 1e-4);
  2. the sharded corpus search (parallel/sharded_search.sharded_topk over
     shard_rows);
  3. the product path: QueryProcessor with tpu.sharded_search on (hash
     embeddings, a Flat index), a hybrid search and process();
  4. the sharded candidate union held to hybrid_topk on the same corpus and
     BM25 plan: the same candidates, fused scores to 1e-3;
  5. the decoder LM's dp x tp train step and greedy generation
     (models/decoder_lm.py's ShardedDecoder).

    python -m anorag_tpu_torch.dryrun_multichip [--devices N] [--device cuda|cpu]

The mesh has N entries (every visible card by default, the CPU once with
--device cpu), taken in turn from the visible devices, so a mesh of more
entries than cards repeats cards; its 'model' axis is 2 for an even N, as
the reference's. The random data comes from numpy's default_rng(0) in the
reference's order; the weights are drawn from torch generators seeded 0
(encoder) and 1 (decoder), where the reference draws them from JAX's keys
0 and 1. Exit 1 when a part fails.
"""
from __future__ import annotations

import argparse
import sys
import traceback
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from anorag_tpu_torch.device import DeviceLike, resolve_device
from anorag_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_rows, visible_devices

ENCODER = {"vocab_size": 512, "hidden_size": 64, "num_layers": 2, "num_heads": 4,
           "intermediate_size": 128, "max_position": 64}
PEOPLE = [("Aurora Lane", "Blue Horizon"), ("Marcus Webb", "Silent River"),
          ("Elena Cortez", "Quantum Leap"), ("David Kim", "Nexus Labs")]


def dryrun_mesh(n_devices: int, device: DeviceLike = None) -> Mesh:
    """n_devices entries over the visible devices of `device`'s kind,
    model_parallel 2 for an even count."""
    return make_mesh(model_parallel=2 if n_devices % 2 == 0 else 1,
                     devices=visible_devices(device, n_devices))


def run(mesh: Mesh, encoder_state: Optional[Mapping[str, torch.Tensor]] = None,
        decoder_state: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """The five parts over `mesh`; the weights are drawn from seeds 0 and
    1 unless given as state dicts. Returns the summary's fields; raises
    AssertionError when a part's check fails."""
    from anorag_tpu_torch.config import Config
    from anorag_tpu_torch.models import decoder_lm as dlm
    from anorag_tpu_torch.models import encoder as enc
    from anorag_tpu_torch.ops.bm25 import build_postings, gather_plan_sorted
    from anorag_tpu_torch.ops.topk import hybrid_topk
    from anorag_tpu_torch.parallel.sharded_search import (
        make_sharded_hybrid_union_topk, sharded_topk)
    from anorag_tpu_torch.query.processor import QueryProcessor
    from anorag_tpu_torch.training.optim import adamw

    dev = mesh.first_device
    n_devices = mesh.size
    model_parallel = mesh.shape["model"]

    # 1. the encoder's dp x tp train step
    cfg = enc.EncoderConfig(**ENCODER)
    if encoder_state is None:
        encoder_state = enc.Encoder(cfg, dev).init_random(
            torch.Generator(device=dev).manual_seed(0)).state_dict()
    params = enc.ShardedEncoder(encoder_state, cfg, mesh)
    step = enc.make_train_step(cfg, adamw(params.parameters(), 1e-4))
    b = max(8, n_devices)
    rng = np.random.default_rng(0)
    batch = {name: torch.from_numpy(rng.integers(3, cfg.vocab_size, (b, 32)))
             if "ids" in name else torch.ones((b, 32), dtype=torch.int32)
             for name in ("q_ids", "q_mask", "p_ids", "p_mask")}
    _, _, loss = step(params, None, batch)
    loss = float(loss)
    assert np.isfinite(loss), "training step produced non-finite loss"

    # 2. the sharded corpus search over the same mesh
    corpus = rng.standard_normal((n_devices * 64, cfg.hidden_size)).astype(np.float32)
    queries = rng.standard_normal((4, cfg.hidden_size)).astype(np.float32)
    emb_sharded, n = shard_rows(mesh, corpus)
    vals, _ = sharded_topk(mesh, emb_sharded, torch.from_numpy(queries).to(dev), k=8,
                           n_total=n)
    assert tuple(vals.shape) == (4, 8)

    # 3. the product path through the user-facing APIs
    pcfg = Config({"embedding": {"backend": "hash", "dim": 128},
                   "vector_store": {"index_type": "Flat"},
                   "tpu": {"sharded_search": "on"},
                   "hybrid_search": {"lexical_fallback": {"noise_threshold": 0.0}},
                   "system": {"device": dev.type}})
    kb = []
    for i in range(4 * n_devices):
        person, work = PEOPLE[i % 4]
        kb.append({"note_id": f"n{i}", "doc_id": f"d{i}", "title": f"{work} {i}",
                   "content": f"{person} created {work}. Fact {i}.",
                   "raw_span": f"{person} created {work}.",
                   "entities": [person, work], "paragraph_idxs": [i]})
    qp = QueryProcessor(kb, cfg=pcfg, llm=None, device=dev.type)
    assert qp.mesh is not None and dict(qp.mesh.shape)
    assert qp.retriever.index.is_sharded, "product index must be mesh-sharded"
    hybrid = qp.retriever.hybrid_search(["Who created Blue Horizon?"], top_k=4)
    assert hybrid and hybrid[0], "sharded hybrid search returned nothing"
    res = qp.process("Who created Blue Horizon?")
    assert res["answer"], "sharded QueryProcessor produced no answer"

    # 4. the sharded BM25 plan and candidate union against hybrid_topk
    n_docs, vocab, d = n_devices * 48, 64, cfg.hidden_size
    doc_terms = [rng.integers(0, vocab, rng.integers(3, 12)).tolist() for _ in range(n_docs)]
    postings = build_postings(doc_terms, vocab)
    q_terms = [rng.integers(0, vocab, 4).tolist() for _ in range(4)]
    doc_rows, weight_rows, _ = gather_plan_sorted(postings, q_terms)
    h_emb = rng.standard_normal((n_docs, d)).astype(np.float32)
    h_emb /= np.linalg.norm(h_emb, axis=1, keepdims=True)
    h_q = rng.standard_normal((4, d)).astype(np.float32)
    h_q /= np.linalg.norm(h_q, axis=1, keepdims=True)
    kq, dk, sm = 8, 16, 8
    plan = [torch.from_numpy(a).to(dev) for a in (h_q, doc_rows, weight_rows)]
    ref_v, ref_i = hybrid_topk(torch.from_numpy(h_emb).to(dev), plan[0], plan[1], plan[2],
                               k=kq, n_docs=n_docs, dense_k=dk, sparse_m=sm)
    h_sharded, h_n = shard_rows(mesh, h_emb)
    sh_v, sh_i = make_sharded_hybrid_union_topk(mesh, k=kq, n_total=h_n, dense_k=dk,
                                                sparse_m=sm)(h_sharded, *plan)
    for bi in range(ref_i.shape[0]):
        want = {int(i): float(v) for i, v in zip(ref_i[bi], ref_v[bi]) if i >= 0}
        got = {int(i): float(v) for i, v in zip(sh_i[bi], sh_v[bi]) if i >= 0}
        assert set(want) == set(got), (
            f"sharded hybrid union diverged from single-device hybrid_topk (query "
            f"{bi}): {sorted(want)} vs {sorted(got)}")
        for i in want:
            assert abs(want[i] - got[i]) < 1e-3, (
                f"fused score mismatch doc {i} query {bi}: {want[i]} vs {got[i]}")

    # 5. the decoder LM's dp x tp train step and generation over the mesh
    dcfg = dlm.DecoderConfig(hidden_size=64, num_layers=2, num_heads=model_parallel * 2,
                             intermediate_size=128, max_len=128)
    if decoder_state is None:
        decoder_state = dlm.init_params(dcfg, torch.Generator(device=dev).manual_seed(1),
                                        dev).state_dict()
    dparams = dlm.ShardedDecoder(decoder_state, dcfg, mesh)
    dstep = dlm.make_train_step(dcfg, adamw(dparams.parameters(), 1e-4))
    db = max(8, n_devices)
    ids = torch.from_numpy(rng.integers(3, 259, (db, 48)).astype(np.int32))
    _, _, dloss = dstep(dparams, None, {"ids": ids, "loss_mask": torch.ones((db, 48))})
    dloss = float(dloss)
    assert np.isfinite(dloss), "decoder LM step non-finite loss"
    toks = dlm.generate(dparams, ids[:, :32].to(dev), torch.zeros(db, dtype=torch.int32,
                                                                  device=dev), dcfg, 4)
    assert tuple(toks.shape) == (db, 4)
    return {"mesh": dict(mesh.shape), "loss": loss,
            "search_top1": vals[:, 0].cpu().numpy().round(3).tolist(),
            "product_sharded_answer": res["answer"],
            "hybrid_top1": hybrid[0][0]["note_id"], "decoder_lm_loss": dloss,
            "decoder_gen_shape": list(toks.shape), "decoder_tokens": toks.cpu()}


def summary(fields: Mapping[str, Any]) -> str:
    """The reference's summary line of run's fields."""
    return (f"dryrun_multichip OK: mesh={fields['mesh']} loss={fields['loss']:.4f} "
            f"search_top1={fields['search_top1']} "
            f"product_sharded_answer={fields['product_sharded_answer']!r} "
            f"hybrid_top1={fields['hybrid_top1']} "
            f"decoder_lm_loss={fields['decoder_lm_loss']:.4f} "
            f"decoder_gen_shape={fields['decoder_gen_shape']}")


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> str:
    """run over dryrun_mesh(n_devices, device); prints and returns the
    summary line."""
    mesh = dryrun_mesh(n_devices, device)
    line = summary(run(mesh))
    print(line, flush=True)
    return line


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh entries (default: every visible card, or the CPU once)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        n = args.devices or len(visible_devices(args.device))
        dryrun_multichip(n, resolve_device(args.device))
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
