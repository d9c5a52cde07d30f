"""Train the in-framework note-generation decoder LM by distillation, on
the card.

Counterpart of scripts/train_note_lm.py, with its flags, printed lines and
report: the rule-based note generator is the teacher, and the byte-level
decoder LM (models/decoder_lm.py) is distilled from (chunk prompt -> note
JSON) and (final-answer prompt -> prediction JSON) pairs over synthetic
worlds (scripts/gen_synth_musique.py, loaded by path), with
adamw(warmup_cosine_decay_schedule) after clip_by_global_norm(1.0)
(training/optim.py, optax's formulas). The checkpoint is save_lm's
params.npz and config.json, which both packages load.

    python -m anorag_tpu_torch.train_note_lm --out checkpoints/note_lm \
        [--items 200] [--steps 1500] [--batch 8] [--seq 1024] [--device cuda]

--device is cuda (the default) or cpu, where the reference's is cpu or tpu.
The initial weights come from a torch.Generator seeded with --seed, so they
differ from the reference's JAX draws for the same seed; the pairs, their
order, the held-out split and the batches are the reference's.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from anorag_tpu_torch.training.synth import synth_generator


def build_answer_pairs(items, rng, max_prompt: int, max_total: int):
    """(rendered final-answer prompt, prediction JSON) pairs.

    Serving calls the LLM with build_final_answer_prompt over the
    SELECTED notes plus a noisy EFSA hint (query/processor.py answer
    stage); the distilled operating point is hint verification — copy
    the (usually right) hint, quote verbatim supporting note bodies,
    emit the gold support idxs — with gold-answer targets throughout so
    a wrong hint is trained to be overridden, and 'insufficient' for
    unanswerable items."""
    import numpy as np

    from anorag_tpu_torch.answer.final_answer import build_numbered_context
    from anorag_tpu_torch.llm.decoder_client import render_prompt
    from anorag_tpu_torch.llm.note_generator import AtomicNoteGenerator
    from anorag_tpu_torch.llm.prompts import (FINAL_ANSWER_SYSTEM,
                                        build_final_answer_prompt)
    from anorag_tpu_torch.config import config

    teacher = AtomicNoteGenerator(llm=None, cfg=config)
    out = []
    n_long = 0
    for it in items:
        paras = it["paragraphs"]
        sup = [p for p in paras if p.get("is_supporting")]
        non = [p for p in paras if not p.get("is_supporting")]
        n_distract = int(rng.integers(1, 4))
        picks = sup + [non[j] for j in
                       rng.permutation(len(non))[:n_distract]]
        notes = []
        for p in picks:
            from anorag_tpu_torch.llm.note_generator import split_sentences
            txt = p["paragraph_text"]
            ns = teacher._rule_fallback(
                txt, split_sentences(txt), title=p.get("title") or "") or []
            body = ns[0]["text"] if ns else p["paragraph_text"]
            notes.append({"title": p.get("title") or "",
                          "content": body,
                          "paragraph_idxs": [p["idx"]],
                          "_sup": bool(p.get("is_supporting"))})
        notes = [notes[j] for j in rng.permutation(len(notes))]
        context, _ = build_numbered_context(notes)
        ans = it.get("answer") or ""
        answerable = bool(it.get("answerable", True))
        r = rng.random()
        if not answerable:
            hint = None if r < 0.5 else _wrong_hint(it, rng)
        elif r < 0.75:
            hint = ans
        elif r < 0.9:
            hint = _wrong_hint(it, rng)
        else:
            hint = None
        prompt = render_prompt(
            build_final_answer_prompt(it["question"], context,
                                      efsa_hint=hint),
            FINAL_ANSWER_SYSTEM)
        if answerable:
            spans = [n["content"] for n in notes if n["_sup"]
                     and ans.lower() in n["content"].lower()][:2]
            if not spans:
                spans = [n["content"] for n in notes if n["_sup"]][:2]
            tgt = {"answer": ans, "evidence_spans": spans,
                   "support_idxs": sorted({n["paragraph_idxs"][0]
                                           for n in notes if n["_sup"]}),
                   "insufficient": False}
        else:
            tgt = {"answer": "insufficient information",
                   "evidence_spans": [], "support_idxs": [],
                   "insufficient": True}
        target = json.dumps(tgt, separators=(",", ":"))
        if len(prompt) > max_prompt or \
                len(prompt) + len(target) + 2 > max_total:
            n_long += 1
            continue
        out.append((prompt, target))
    return out, n_long


def _wrong_hint(item, rng):
    """A plausible-but-wrong hint: an entity-ish span from a
    non-supporting paragraph title."""
    non = [p.get("title") or "" for p in item["paragraphs"]
           if not p.get("is_supporting")]
    if not non:
        return None
    t = str(non[int(rng.integers(0, len(non)))])
    return t.replace(" (album)", "") or None


def build_copy_pairs(rng, count: int, max_total: int):
    """Echo pairs over the synthetic name distribution.

    Byte-level copying of NOVEL names is the hard sub-skill of both real
    tasks (the first distilled checkpoint emitted perfect JSON schema
    with hallucinated entity names — induction never formed). A pure
    copy curriculum gives the induction circuit a dense training signal:
    every target byte must be read from the prompt."""
    gen = synth_generator()
    _world, _paragraphs = gen._world, gen._paragraphs

    from anorag_tpu_torch.llm.decoder_client import render_prompt

    out = []
    for _ in range(count):
        w = _world(rng)
        paras = _paragraphs(w, rng)
        k = int(rng.integers(1, 3))
        picks = [paras[int(j)][1] for j in
                 rng.permutation(len(paras))[:k]]
        text = " ".join(picks)
        prompt = render_prompt(text, "Copy the text exactly.")
        if len(prompt) + len(text) + 2 > max_total:
            continue
        out.append((prompt, text))
    return out


def build_pairs(n_items: int, seeds, max_prompt: int, max_total: int,
                merged_only: bool = True, tasks=("notes", "answer"),
                answer_boost: int = 4, copy_pairs: int = 0,
                target_keys: bool = False):
    """(rendered prompt, completion JSON) pairs from synthetic worlds."""
    make_items = synth_generator().make_items

    from anorag_tpu_torch.config import config
    from anorag_tpu_torch.doc.chunker import DocumentChunker
    from anorag_tpu_torch.llm.decoder_client import render_prompt
    from anorag_tpu_torch.llm.note_generator import (AtomicNoteGenerator,
                                               extract_all_note_keys)
    from anorag_tpu_torch.llm.prompts import (ATOMIC_NOTE_SYSTEM,
                                        build_atomic_note_prompt)

    chunker = DocumentChunker()
    teacher = AtomicNoteGenerator(llm=None, cfg=config)
    pairs = []
    seen = set()
    n_long = 0
    # distractors stays at the generator default (12): several question
    # kinds rejection-sample foils from the distractor pool and spin
    # forever below ~8 worlds
    rng = np.random.default_rng(seeds[0] if seeds else 0)
    if copy_pairs:
        pairs.extend(build_copy_pairs(rng, copy_pairs, max_total))
    for seed in seeds:
        items = make_items(n_items, 12, seed)
        if "answer" in tasks:
            # the note task yields ~30-50 pairs per item (one per
            # paragraph) vs ONE answer pair — draw extra worlds so the
            # answer task is not drowned in the mixture
            a_items = list(items)
            for j in range(max(0, answer_boost - 1)):
                a_items += make_items(n_items, 12, seed + 7919 * (j + 1))
            apairs, a_long = build_answer_pairs(a_items, rng, max_prompt,
                                                max_total)
            n_long += a_long
            for p, t in apairs:
                key = hash(p)
                if key not in seen:
                    seen.add(key)
                    pairs.append((p, t))
        if "notes" not in tasks:
            continue
        for it in items:
            for para in it["paragraphs"]:
                doc = {"id": f"{it['id']}_{para['idx']}",
                       "paragraphs": [para]}
                for ch in chunker.chunk_document(doc):
                    notes = teacher._rule_fallback(
                        ch["text"], ch["sentences"], title=ch.get("title") or "")
                    if not notes:
                        continue
                    if merged_only and len(notes) > 1:
                        # the downstream per-paragraph quota (notes_llm.
                        # limit, quota 1) keeps only the top-salience note
                        # — the merged info-complete one; distilling just
                        # it halves target bytes with no pipeline effect
                        notes = notes[:1]
                    # key triples in targets are pure overhead unless
                    # explicitly requested: _post_process re-extracts
                    # the SAME triples from the note text with the SAME
                    # rule extractor whether or not the model emits
                    # them, and secondary_keys were measured to blow the
                    # merged note past max_new=512 (every parse_fail in
                    # the round-4 LLM-notes eval was that truncation)
                    if target_keys:
                        for n in notes:
                            keys = extract_all_note_keys(
                                n["text"], n["entities"],
                                teacher.rel_lexicon,
                                teacher.fallback_splitters,
                                teacher.default_rel)
                            if keys:
                                n.update(keys)
                    prompt = render_prompt(
                        build_atomic_note_prompt(ch["text"], ch["sentences"]),
                        ATOMIC_NOTE_SYSTEM)
                    # budget-greedy target: the merged info-complete note
                    # leads (it alone survives the downstream per-paragraph
                    # quota, notes_llm.limit quota 1); sentence notes ride
                    # along while the byte budget holds
                    budget = max_total - len(prompt) - 2
                    kept_notes = []
                    used = 2                       # '[' + ']'
                    for n in notes:
                        s = len(json.dumps(n, separators=(",", ":"))) + 1
                        if used + s > budget:
                            break
                        kept_notes.append(n)
                        used += s
                    if not kept_notes:
                        n_long += 1
                        continue
                    target = json.dumps(kept_notes, separators=(",", ":"))
                    if len(prompt) > max_prompt or \
                            len(prompt) + len(target) + 2 > max_total:
                        n_long += 1
                        continue
                    key = hash(prompt)
                    if key in seen:
                        continue
                    seen.add(key)
                    pairs.append((prompt, target))
    return pairs, n_long


def encode_pairs(pairs, seq_len: int):
    from anorag_tpu_torch.models.decoder_lm import PAD_ID, ByteTokenizer

    tok = ByteTokenizer()
    ids = np.full((len(pairs), seq_len), PAD_ID, np.int32)
    w = np.zeros((len(pairs), seq_len), np.float32)
    kept = []
    for p, c in pairs:
        pi = tok.encode(p, add_bos=True)
        ci = tok.encode(c, add_eos=True)
        if len(pi) + len(ci) > seq_len:
            continue
        i = len(kept)
        if i >= len(pairs):
            break
        seq = pi + ci
        ids[i, :len(seq)] = seq
        w[i, len(pi):len(seq)] = 1.0
        kept.append((p, c))
    return ids[:len(kept)], w[:len(kept)], kept


def evaluate(lm, held, max_new: int):
    """Parse rate + teacher fidelity of greedy generations.

    Note-task targets are JSON LISTS (note objects, scored by text
    recall); answer-task targets are JSON DICTS (prediction objects,
    scored by answer match)."""
    from anorag_tpu_torch.utils.json_parser import extract_json, extract_prediction

    n_parse = n_exact = 0
    note_hits = note_total = 0
    ans_hits = ans_total = 0
    copy_hits = copy_total = 0
    for i in range(0, len(held), 8):
        batch = held[i:i + 8]
        outs = lm.generate([p for p, _ in batch], max_new=max_new)
        for (p, tgt), got in zip(batch, outs):
            try:
                want = json.loads(tgt)
            except ValueError:                              # copy task
                copy_total += 1
                if got.strip() == tgt.strip():
                    copy_hits += 1
                continue
            if isinstance(want, dict):                      # answer task
                ans_total += 1
                pred = extract_prediction(got)
                if isinstance(pred, dict) and pred.get("answer"):
                    n_parse += 1
                    if str(pred.get("answer")).strip().lower() == \
                            str(want.get("answer")).strip().lower():
                        ans_hits += 1
                    if got.strip() == tgt.strip():
                        n_exact += 1
                continue
            parsed = extract_json(got)
            if isinstance(parsed, list) and parsed:
                n_parse += 1
                want_texts = {n.get("text") for n in want}
                got_texts = {n.get("text") for n in parsed
                             if isinstance(n, dict)}
                note_total += len(want_texts)
                note_hits += len(want_texts & got_texts)
                if got.strip() == tgt.strip():
                    n_exact += 1
            else:
                note_total += len(want)
    n = max(len(held), 1)
    return {"parse_rate": n_parse / max(n - copy_total, 1),
            "exact_rate": n_exact / max(n - copy_total, 1),
            "note_text_recall": note_hits / max(note_total, 1),
            "answer_match": ans_hits / max(ans_total, 1),
            "copy_exact": copy_hits / max(copy_total, 1),
            "n_eval_answer": ans_total, "n_eval_copy": copy_total,
            "n_eval": len(held)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="checkpoints/note_lm")
    ap.add_argument("--items", type=int, default=200)
    ap.add_argument("--seeds", type=int, nargs="+", default=[101, 102, 103])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--ffn", type=int, default=1024)
    ap.add_argument("--max-len", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--held-out", type=int, default=64)
    ap.add_argument("--eval-max-new", type=int, default=0,
                    help="byte budget for held-out generations (0 = --seq)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tasks", nargs="+", default=["notes", "answer"],
                    choices=["notes", "answer"])
    ap.add_argument("--target-keys", action="store_true",
                    help="emit head/rel/tail + secondary_keys in note "
                         "targets (off: shorter targets, keys re-derived "
                         "from text downstream)")
    ap.add_argument("--copy-pairs", type=int, default=0,
                    help="extra pure-copy curriculum pairs (induction "
                         "bootstrap)")
    ap.add_argument("--answer-boost", type=int, default=4,
                    help="extra world draws for the answer task (one "
                         "answer pair per item vs ~30-50 note pairs)")
    ap.add_argument("--save-every", type=int, default=0,
                    help="checkpoint every N steps (long runs must survive "
                         "being cut short)")
    ap.add_argument("--stats-only", action="store_true")
    ap.add_argument("--init-from", default=None,
                    help="warm-start params from an existing checkpoint dir "
                         "(the optimizer state restarts, so pass a reduced "
                         "--lr and only the REMAINING --steps)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    t0 = time.time()
    pairs, n_long = build_pairs(args.items, args.seeds,
                                max_prompt=int(args.seq * 0.7),
                                max_total=args.seq,
                                tasks=tuple(args.tasks),
                                answer_boost=args.answer_boost,
                                copy_pairs=args.copy_pairs,
                                target_keys=args.target_keys)
    lens = sorted(len(p) + len(c) for p, c in pairs)
    print(f"pairs: {len(pairs)} (dropped {n_long} over budget) "
          f"len p50={lens[len(lens)//2]} p95={lens[int(len(lens)*.95)]} "
          f"max={lens[-1]} build {time.time()-t0:.1f}s")
    if args.stats_only:
        return 0

    import torch

    from anorag_tpu_torch.device import resolve_device
    from anorag_tpu_torch.models import decoder_lm as dlm
    from anorag_tpu_torch.training.optim import (adamw, clip_by_global_norm,
                                                 warmup_cosine_decay_schedule)

    device = resolve_device(args.device)
    rng = np.random.default_rng(args.seed)
    order = rng.permutation(len(pairs))
    pairs = [pairs[i] for i in order]
    held = pairs[:args.held_out]
    train = pairs[args.held_out:]
    ids, w, kept = encode_pairs(train, args.seq)
    print(f"train {len(kept)} / held-out {len(held)}")

    cfg = dlm.DecoderConfig(hidden_size=args.hidden, num_layers=args.layers,
                            num_heads=args.heads,
                            intermediate_size=args.ffn, max_len=args.max_len)
    if args.init_from:
        params, ck_cfg = dlm.load_lm(args.init_from, device)
        if ck_cfg != cfg:
            raise SystemExit(f"--init-from config mismatch: {ck_cfg} != {cfg}")
        print(f"warm-started from {args.init_from}")
    else:
        params = dlm.init_params(
            cfg, torch.Generator(device=device).manual_seed(args.seed), device)
    params.requires_grad_(True)
    sched = warmup_cosine_decay_schedule(
        0.0, args.lr, args.warmup, max(args.steps, args.warmup + 1), args.lr * 0.05)
    step_fn = dlm.make_train_step(cfg, adamw(params.parameters(), sched),
                                  clip=clip_by_global_norm(1.0))

    n = ids.shape[0]
    t0 = time.time()
    loss_hist = []
    for step in range(args.steps):
        idx = rng.integers(0, n, size=args.batch)
        batch = {"ids": torch.from_numpy(ids[idx]).to(device),
                 "loss_mask": torch.from_numpy(w[idx]).to(device)}
        params, _, loss = step_fn(params, None, batch)
        if step % 50 == 0 or step == args.steps - 1:
            lv = float(loss)
            loss_hist.append({"step": step, "loss": round(lv, 4)})
            dt = time.time() - t0
            print(f"step {step} loss {lv:.4f} ({dt:.0f}s, "
                  f"{(step+1)/max(dt,1e-9):.2f} it/s)", flush=True)
        if args.save_every and step and step % args.save_every == 0:
            dlm.save_lm(args.out, params, cfg)
            print(f"checkpoint saved at step {step}", flush=True)

    params.requires_grad_(False)
    dlm.save_lm(args.out, params, cfg)
    lm = dlm.DecoderLM(params, cfg, prompt_bucket=256)
    metrics = evaluate(lm, held, max_new=args.eval_max_new or args.seq)
    n_params = sum(p.numel() for p in params.parameters())
    report = {
        "out": args.out, "n_params": n_params, "config": cfg.as_dict(),
        "n_train": len(kept), "n_held_out": len(held),
        "steps": args.steps, "batch": args.batch, "seq": args.seq,
        "train_seconds": round(time.time() - t0, 1),
        "final_loss": loss_hist[-1]["loss"] if loss_hist else None,
        "loss_history": loss_hist, "held_out": metrics,
    }
    Path(args.out).mkdir(parents=True, exist_ok=True)
    (Path(args.out) / "report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"held_out": metrics, "n_params": n_params,
                      "final_loss": report["final_loss"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
