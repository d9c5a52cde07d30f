"""Train and ship a small in-domain retrieval encoder checkpoint, on the card.

Counterpart of scripts/train_retrieval_encoder.py, with its flags, printed
lines and report:

    python -m anorag_tpu_torch.train_retrieval_encoder [--out checkpoints/encoder_synth_small] \
        [--train-worlds 2000] [--eval-worlds 500] [--steps 600] [--batch 128] \
        [--hidden 256] [--layers 4] [--heads 8] [--ffn 1024] [--vocab 8192] \
        [--lr 3e-4] [--remat] [--f32-params] [--warmup 100] [--device cuda] \
        [--devices N]

Data: synthetic MuSiQue-style worlds (scripts/gen_synth_musique.py's
templates, loaded by path). Training pairs are (question-surface query,
gold paragraph); evaluation is recall@10 of the gold paragraph among a
held-out corpus of unseen worlds, against the random-init encoder and the
hash n-gram embedder. InfoNCE with adamw under a linear warmup from 0
(models/train.py). --f32-params trains f32 masters with bf16 compute and
saves the weights at the inference dtypes (bf16 weights, f32 layer norms).
The checkpoint is the encoder's state dict written with torch.save to
--out, the file embedding.checkpoint_path reads (the reference writes an
orbax directory there), and <out>_report.json beside it holds the
reference's keys. --device: cuda (the default) or cpu, where training runs.
--devices N trains data parallel over a mesh of N entries that take the
visible devices in turn, repeating a device where fewer are visible. The
reference trains over every chip it sees; here a mesh over several cards is
slower than one card (PERF.md §6), so the default is the one device.
"""
from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from anorag_tpu_torch.training.synth import synth_generator


def make_world_pairs(n: int, seed: int):
    """[(query, gold paragraph text)] — one QA-surface query per paragraph
    fact, mirroring the questions the synthetic eval asks."""
    gen = synth_generator()
    rng = np.random.default_rng(seed)
    pairs = []
    corpus = []
    for _ in range(n):
        w = gen._world(rng)
        paras = gen._paragraphs(w, rng)
        texts = [f"{t}. {x}" for t, x in paras]
        corpus.extend(texts)
        base = len(corpus) - len(texts)
        qs = [
            (f"Who performed {w['work']}?", base + 0),
            (f"When was {w['work']} released?", base + 0),
            (f"Who is the spouse of {w['person']}?", base + 1),
            (f"Where was {w['person']} born?", base + 1),
            (f"Where was {w['spouse']} born?", base + 2),
            (f"Who founded {w['label']}?", base + 3),
            (f"Who is the spouse of {w['founder']}?", base + 4),
        ]
        pairs.extend((q, corpus[gi], gi) for q, gi in qs)
    return pairs, corpus


def recall_at_k(q_emb, c_emb, gold, k=10):
    sims = q_emb @ c_emb.T
    topk = np.argpartition(-sims, min(k, sims.shape[1] - 1), axis=1)[:, :k]
    return float(np.mean([gold[i] in set(topk[i]) for i in range(len(gold))]))


def embed(model, tok, texts, bs=256) -> np.ndarray:
    """(len(texts), H) f32 embeddings of `model`, in chunks of `bs` texts
    padded with empty ones, each row padded to max_position wide, as the
    reference embeds them."""
    cfg, dev = model.cfg, model.tok_emb.device
    out = []
    for lo in range(0, len(texts), bs):
        chunk = list(texts[lo:lo + bs])
        pad_to = bs - len(chunk)
        chunk += [""] * pad_to
        ids, mask = tok.encode_batch(chunk, cfg.max_position)
        width = cfg.max_position
        ids = np.pad(ids, ((0, 0), (0, width - ids.shape[1])), constant_values=2)
        mask = np.pad(mask, ((0, 0), (0, width - mask.shape[1])))
        with torch.no_grad():
            e = model(torch.from_numpy(ids).to(dev, torch.long),
                      torch.from_numpy(mask).to(dev)).cpu().numpy()
        out.append(e[: bs - pad_to] if pad_to else e)
    return np.concatenate(out, axis=0)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="checkpoints/encoder_synth_small")
    ap.add_argument("--train-worlds", type=int, default=2000)
    ap.add_argument("--eval-worlds", type=int, default=500)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--ffn", type=int, default=1024)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", action="store_true",
                    help="per-layer activation checkpointing (big configs)")
    ap.add_argument("--f32-params", action="store_true",
                    help="f32 master weights, bf16 compute (big configs: bf16 "
                         "masters round adamw updates to zero)")
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--devices", type=int, default=None,
                    help="mesh entries, taken from the visible devices in turn (default: "
                         "the one device; several cards are slower than one for now)")
    args = ap.parse_args(argv)

    from anorag_tpu_torch.models import encoder as enc
    from anorag_tpu_torch.models.hash_embedder import HashEmbedder
    from anorag_tpu_torch.models.tokenizer import HashTokenizer
    from anorag_tpu_torch.models.train import EncoderTrainer, save_state_dict
    from anorag_tpu_torch.parallel.mesh import visible_devices
    from anorag_tpu_torch.training.optim import linear_schedule

    cfg = enc.EncoderConfig(
        vocab_size=args.vocab, hidden_size=args.hidden,
        num_layers=args.layers, num_heads=args.heads,
        intermediate_size=args.ffn, max_position=128, pooling="mean",
        remat=args.remat,
        param_dtype=torch.float32 if args.f32_params else None)
    train_pairs, _ = make_world_pairs(args.train_worlds, seed=0)
    eval_pairs, eval_corpus = make_world_pairs(args.eval_worlds, seed=99)
    print(f"train pairs: {len(train_pairs)}, eval queries: {len(eval_pairs)}, "
          f"eval corpus: {len(eval_corpus)}", flush=True)

    tok = HashTokenizer(cfg.vocab_size, cfg.max_position)
    gold = [gi for _, _, gi in eval_pairs]
    queries = [q for q, _, _ in eval_pairs]

    # baselines
    hash_emb = HashEmbedder(dim=cfg.hidden_size)
    r_hash = recall_at_k(hash_emb.encode(queries), hash_emb.encode(eval_corpus), gold)

    lr_sched = linear_schedule(0.0, args.lr, max(args.warmup, 1))
    trainer = EncoderTrainer(cfg=cfg, learning_rate=lr_sched,
                             devices=(visible_devices(args.device, args.devices)
                                      if args.devices else [args.device]))
    initial = trainer.model
    r_random = recall_at_k(embed(initial, tok, queries), embed(initial, tok, eval_corpus),
                           gold)
    del initial
    print(f"recall@10 random-init encoder: {r_random:.4f}", flush=True)
    print(f"recall@10 hash embedder:       {r_hash:.4f}", flush=True)

    # train: cap steps by slicing pairs per epoch
    pairs2 = [(q, p) for q, p, _ in train_pairs]
    steps_per_epoch = len(pairs2) // args.batch
    epochs = max(1, -(-args.steps // steps_per_epoch))
    t0 = time.perf_counter()
    hist = trainer.train(pairs2, tokenizer=tok, epochs=epochs,
                         batch_size=args.batch, max_length=cfg.max_position)
    dt = time.perf_counter() - t0
    print(f"trained {len(hist)} steps in {dt:.0f}s "
          f"(loss {hist[0]:.3f} -> {hist[-1]:.3f})", flush=True)

    trained = trainer.model
    r_trained = recall_at_k(embed(trained, tok, queries), embed(trained, tok, eval_corpus),
                            gold)
    print(f"recall@10 trained encoder:     {r_trained:.4f}", flush=True)

    out = Path(args.out)
    if out.is_dir():
        shutil.rmtree(out)
    if args.f32_params:
        # ship the checkpoint at the INFERENCE dtypes (bf16 dense weights,
        # f32 layer norms): half the bytes, and the encoder a default
        # config builds takes it as it is
        ref_cfg = enc.EncoderConfig(
            vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
            num_layers=cfg.num_layers, num_heads=cfg.num_heads,
            intermediate_size=cfg.intermediate_size,
            max_position=cfg.max_position, pooling=cfg.pooling)
        shipped = enc.Encoder(ref_cfg, trainer.device)
        shipped.load_state_dict(trainer.state_dict())
        ok = save_state_dict(shipped.state_dict(), out.resolve())
    else:
        ok = trainer.save_checkpoint(out.resolve())
    report = {
        "config": {"vocab": cfg.vocab_size, "hidden": cfg.hidden_size,
                   "layers": cfg.num_layers, "heads": cfg.num_heads,
                   "ffn": cfg.intermediate_size, "pooling": cfg.pooling},
        "train_pairs": len(pairs2), "steps": len(hist),
        "loss_first": round(hist[0], 4), "loss_last": round(hist[-1], 4),
        "eval_corpus": len(eval_corpus), "eval_queries": len(queries),
        "recall_at_10": {"trained": round(r_trained, 4),
                         "random_init": round(r_random, 4),
                         "hash_embedder": round(r_hash, 4)},
        "checkpoint_saved": ok, "checkpoint_path": str(out),
        "train_seconds": round(dt, 1),
    }
    with open(out.parent / f"{out.name}_report.json", "w") as fh:
        json.dump(report, fh, indent=2)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
