"""Discriminating encoder eval: trained vs hash vs random, on the card.

Counterpart of scripts/eval_encoder_discrimination.py, with its flags,
printed lines and report:

    python -m anorag_tpu_torch.eval_encoder_discrimination [--worlds 60] \
        [--group 12] [--seed 31] [--ckpt checkpoints/encoder_synth_full] \
        [--skip-trained] [--report docs/encoder_discrimination.json] \
        [--device cuda]

The corpus is built to separate a trained encoder from a hash function:
worlds share work-title first words and suffixes, and queries and evidence
are paraphrased with different dev banks of scripts/gen_heldout_musique.py
(questions d1, evidence d2), both generators loaded by path
(make_confusable_eval and recall_at_k are the root script's). Arms: the
hash embedder, the encoder at the checkpoint's shape with random weights,
and the trained checkpoint; recall@10 of each.

Where the port differs:
  * the random arm's weights are drawn by the port's seeded init
    (Encoder.init_random, a torch.Generator seeded 0 on --device); the
    reference's jax.random.PRNGKey(0) draws cannot be reproduced in torch,
    so that arm's recall may differ from the root script's;
  * --ckpt is a torch state dict, as train_retrieval_encoder --out writes
    it, where the root script restores an orbax directory; a directory
    there is refused with an error;
  * the checkpoint's shape is read from <ckpt>_report.json's "config" by
    the root script's keys (vocab_size, hidden_size, ...) and, where those
    are missing, by the keys train_retrieval_encoder writes (vocab,
    hidden, ...), then the root script's defaults;
  * --device: cuda (the default) or cpu, where the root script takes cpu
    or tpu.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from anorag_tpu_torch.device import resolve_device
from anorag_tpu_torch.models import encoder as enc
from anorag_tpu_torch.models.hash_embedder import HashEmbedder
from anorag_tpu_torch.models.tokenizer import HashTokenizer
from anorag_tpu_torch.train_retrieval_encoder import embed
from anorag_tpu_torch.training.synth import heldout_generator, synth_generator

# the report's "config" keys: the root script's, then train_retrieval_encoder's
_SHAPE_KEYS = (("vocab_size", "vocab", 8192), ("hidden_size", "hidden", 1024),
               ("num_layers", "layers", 24), ("num_heads", "heads", 16),
               ("intermediate_size", "ffn", 4096))


def make_confusable_eval(n_worlds: int, group: int, seed: int):
    """[(query, gold_idx)] + corpus with shared-title-token worlds and
    cross-bank paraphrase (questions d1, evidence d2)."""
    held, synth = heldout_generator(), synth_generator()
    _E_D2, _Q_D1, _apply = held._E_D2, held._Q_D1, held._apply
    _SYL, _paragraphs, _world = synth._SYL, synth._paragraphs, synth._world

    rng = np.random.default_rng(seed)
    firsts = []
    while len(firsts) < max(1, n_worlds // group):
        f = "".join(rng.choice(_SYL, 2)).capitalize()
        if f not in firsts:
            firsts.append(f)
    corpus, queries, gold = [], [], []
    seen = set()
    for i in range(n_worlds):
        # the (first-word x suffix) space is small (~8 suffixes); bound
        # the fresh-title retry and widen to a random first word when a
        # group exhausts its combinations
        for tries in range(60):
            w = _world(rng, work_first=(firsts[i % len(firsts)]
                                        if tries < 30 else None))
            if w["work"] not in seen:
                seen.add(w["work"])
                break
        paras = _paragraphs(w, rng)
        texts = [_apply(f"{t}. {x}", _E_D2, rng, p=1.0) for t, x in paras]
        base = len(corpus)
        corpus.extend(texts)
        for q, gi in (
            (f"Who performed {w['work']}?", 0),
            (f"When was {w['work']} released?", 0),
            (f"Where was {w['person']} born?", 1),
        ):
            queries.append(_apply(q, _Q_D1, rng, p=1.0))
            gold.append(base + gi)
    return queries, corpus, gold


def recall_at_k(q_emb, c_emb, gold, k=10):
    sims = q_emb @ c_emb.T
    topk = np.argpartition(-sims, min(k, sims.shape[1] - 1), axis=1)[:, :k]
    return float(np.mean([gold[i] in set(topk[i]) for i in range(len(gold))]))


def checkpoint_config(ckpt: str) -> enc.EncoderConfig:
    """The encoder shape of <ckpt>_report.json (see the module docstring),
    128 positions, mean pooling."""
    rp = Path(ckpt + "_report.json")
    meta = json.loads(rp.read_text()) if rp.exists() else {}
    ecfg = meta.get("config") or {}
    shape = {key: int(ecfg.get(key, ecfg.get(short, default)))
             for key, short, default in _SHAPE_KEYS}
    return enc.EncoderConfig(**shape, max_position=128, pooling="mean")


def random_encoder(cfg: enc.EncoderConfig, device: torch.device) -> enc.Encoder:
    """The random arm: the port's init drawn from a generator seeded 0."""
    gen = torch.Generator(device=device).manual_seed(0)
    return enc.Encoder(cfg, device).init_random(gen)


def trained_encoder(cfg: enc.EncoderConfig, ckpt: str, device: torch.device) -> enc.Encoder:
    """The trained arm: the torch state dict at `ckpt`; SystemExit for an
    orbax directory."""
    if Path(ckpt).is_dir():
        raise SystemExit(f"{ckpt} is a directory, the JAX package's orbax "
                         "checkpoint; the port reads a torch state dict there "
                         "(python -m anorag_tpu_torch.train_retrieval_encoder --out)")
    model = enc.Encoder(cfg, device)
    model.load_state_dict(torch.load(Path(ckpt).resolve(), map_location=device,
                                     weights_only=True))
    return model


def arm_recall(model: enc.Encoder, tok: HashTokenizer, queries, corpus, gold) -> float:
    """recall@10 of `model`'s embeddings, 128 texts a batch, each row padded
    to max_position, as the root script embeds them."""
    return recall_at_k(embed(model, tok, queries, bs=128),
                       embed(model, tok, corpus, bs=128), gold)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=60)
    ap.add_argument("--group", type=int, default=12,
                    help="worlds sharing each title first-word")
    ap.add_argument("--seed", type=int, default=31)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ckpt", default="checkpoints/encoder_synth_full")
    ap.add_argument("--skip-trained", action="store_true",
                    help="hash/random arms only (no checkpoint restore)")
    ap.add_argument("--report", default="docs/encoder_discrimination.json")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    queries, corpus, gold = make_confusable_eval(
        args.worlds, args.group, args.seed)
    print(f"{len(queries)} queries over {len(corpus)} confusable "
          f"paragraphs", flush=True)

    report = {"protocol": "confusable titles (shared first words/suffixes) "
                          "+ cross-bank paraphrase (q=d1, evidence=d2)",
              "n_queries": len(queries), "n_corpus": len(corpus),
              "group": args.group, "seed": args.seed}
    hash_emb = HashEmbedder(dim=1024)
    report["recall10_hash"] = round(recall_at_k(
        hash_emb.encode(queries), hash_emb.encode(corpus), gold), 4)
    print(json.dumps({"hash": report["recall10_hash"]}), flush=True)

    if not args.skip_trained:
        cfg = checkpoint_config(args.ckpt)
        tok = HashTokenizer(cfg.vocab_size, cfg.max_position)
        report["recall10_random_init"] = round(arm_recall(
            random_encoder(cfg, device), tok, queries, corpus, gold), 4)
        print(json.dumps({"random": report["recall10_random_init"]}),
              flush=True)

        report["recall10_trained"] = round(arm_recall(
            trained_encoder(cfg, args.ckpt, device), tok, queries, corpus, gold), 4)
        print(json.dumps({"trained": report["recall10_trained"]}),
              flush=True)

    Path(args.report).write_text(json.dumps(report, indent=2))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
