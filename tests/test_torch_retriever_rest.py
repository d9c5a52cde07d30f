"""The rest of the port's retriever against anorag_tpu's, on the CPU.

VectorRetriever's lexical and namespace fallbacks, add_notes /
remove_notes / update_note (through _rebuild), save / load (the
reference's files, read by either package; load refusing a mismatched
model signature), optimize_retrieval_params; VectorIndex.save / load;
EmbeddingManager.model_signature / check_signature and load_checkpoint,
whose format differs by design (a torch state dict of the port's encoder,
where the reference restores an orbax checkpoint). The hash embedder on
the same notes (tests/test_torch_slice.py's): note ids equal in equal
order, scores to 1e-5 (the corpus is stored in bf16 in both packages; the
fallbacks' BM25 scores are f32 host sums).
"""
import json

import numpy as np
import pytest
import torch

from anorag_tpu.config import ConfigLoader
from anorag_tpu.index.vector_index import VectorIndex as JVectorIndex
from anorag_tpu.models.embedding_manager import EmbeddingManager as JEmbeddingManager
from anorag_tpu.retrieval.retriever import VectorRetriever as JVectorRetriever
from anorag_tpu.retrieval.retriever import \
    optimize_retrieval_params as j_optimize_retrieval_params
from anorag_tpu_torch.index.vector_index import VectorIndex
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.models.encoder import EncoderConfig
from anorag_tpu_torch.retrieval.retriever import (VectorRetriever,
                                                  optimize_retrieval_params)

from test_torch_slice import _notes

QUERIES = ["Who is the singer of Blue Horizon?", "Who founded Nexus Labs?",
           "quartz harbor lantern", "comet ember glacier falcon marble",
           "violin meadow river album", "nebula atlas cobalt"]


def _sets(**over):
    return {"embedding.backend": "hash", "embedding.dim": 64,
            "vector_store.index_type": "Flat", "tpu.sharded_search": "off", **over}


def _loader(**over):
    loader = ConfigLoader(auto_load=False)
    for k, v in _sets(**over).items():
        loader.set(k, v)
    return loader


def _pair(notes=None, index_type="Flat", **over):
    loader = _loader(**over)
    jem = JEmbeddingManager(cfg=loader, singleton=False)
    em = EmbeddingManager(loader.as_dict(), device="cpu")
    jr = JVectorRetriever(embedding_manager=jem, index_type=index_type, top_k=8)
    r = VectorRetriever(em, index_type=index_type, top_k=8)
    notes = _notes(n_extra=120) if notes is None else notes
    jr.build_index(notes)
    r.build_index(notes)
    return jr, r


def _same(got, want, key="final_score", atol=1e-5):
    assert [n["note_id"] for n in got] == [n["note_id"] for n in want]
    np.testing.assert_allclose([n[key] for n in got], [n[key] for n in want],
                               atol=atol, rtol=0)
    for g, w in zip(got, want):
        assert g.get("retrieval_info", {}).get("method") == \
            w.get("retrieval_info", {}).get("method")


def _retrieve_all(r, **kw):
    return [r.retrieve(q, threshold=-1.0, **kw) for q in QUERIES]


@pytest.mark.parametrize("top_k", [1, 5, 20])
def test_lexical_fallback_search_equals_the_reference(top_k):
    jr, r = _pair()
    for q in QUERIES + ["zzzz unknown words", ""]:
        _same(r.lexical_fallback_search(q, top_k=top_k),
              jr.lexical_fallback_search(q, top_k=top_k))
    empty = VectorRetriever(r.em)
    empty.build_index([])
    assert empty.lexical_fallback_search("anything") == [] and empty._lexical_terms("x") == []


@pytest.mark.parametrize("namespace", [None, "doc_g3", "doc_g11", "no_such_doc"])
def test_search_with_namespace_fallback_equals_the_reference(namespace):
    jr, r = _pair()
    for q in QUERIES:
        got = r.search_with_namespace_fallback(q, namespace, top_k=5)
        _same(got, jr.search_with_namespace_fallback(q, namespace, top_k=5))
        assert namespace is None or all(str(n["doc_id"]) == namespace for n in got)


def test_lexical_terms_equal_the_reference():
    jr, r = _pair()
    for q in QUERIES:
        assert r._lexical_terms(q) == jr._lexical_terms(q)


def test_add_remove_update_equal_the_reference():
    notes = _notes(n_extra=120)
    jr, r = _pair(notes[:100])
    jr.add_notes(notes[100:])
    r.add_notes(notes[100:])
    r.add_notes([])
    for got, want in zip(_retrieve_all(r), _retrieve_all(jr)):
        _same(got, want)
    assert r.embeddings.shape == (len(notes), 64) and r.embeddings.dtype == torch.float32
    gone = [n["note_id"] for n in notes[::7]] + ["no_such_note"]
    assert r.remove_notes(gone) == jr.remove_notes(gone) == len(notes[::7])
    for got, want in zip(_retrieve_all(r), _retrieve_all(jr)):
        _same(got, want)
    np.testing.assert_allclose(r.embeddings.numpy(), jr.embeddings, atol=1e-6)
    edited = dict(notes[3], content="Aurora Lane wrote the quartz harbor lantern song.")
    assert r.update_note(edited) and jr.update_note(edited)
    assert not r.update_note({"note_id": "no_such_note"})
    for got, want in zip(_retrieve_all(r, top_k=10), _retrieve_all(jr, top_k=10)):
        _same(got, want)
    assert [n["note_id"] for n in r.notes] == [n["note_id"] for n in jr.notes]


def test_remove_then_add_gives_the_same_top_sets():
    notes = _notes(n_extra=120)
    _, r = _pair(notes)
    before = [{n["note_id"] for n in row} for row in _retrieve_all(r, top_k=10)]
    gone = notes[::9]
    r.remove_notes([n["note_id"] for n in gone])
    r.add_notes(gone)
    assert [{n["note_id"] for n in row} for row in _retrieve_all(r, top_k=10)] == before


def test_update_note_leaves_the_callers_embeddings_alone():
    notes = _notes(n_extra=20)
    em = EmbeddingManager(_loader().as_dict(), device="cpu")
    emb = em.encode_atomic_notes(notes)
    keep = emb.clone()
    r = VectorRetriever(em, index_type="Flat")
    r.build_index(notes, emb)
    assert r.update_note(dict(notes[0], content="something else entirely"))
    assert torch.equal(emb, keep)


@pytest.mark.parametrize("saver,loader_pkg", [("port", "port"), ("ref", "port"),
                                              ("port", "ref")])
def test_save_load_round_trip_across_packages(tmp_path, saver, loader_pkg):
    jr, r = _pair()
    (r if saver == "port" else jr).save(tmp_path)
    assert {p.name for p in tmp_path.iterdir()} == {
        "atomic_notes.json", "note_embeddings.npz", "id_mappings.json",
        "model_signature.json"}
    fresh = (VectorRetriever(r.em, index_type="Flat", top_k=8) if loader_pkg == "port"
             else JVectorRetriever(embedding_manager=jr.em, index_type="Flat", top_k=8))
    assert fresh.load(tmp_path)
    for got, want in zip(_retrieve_all(fresh), _retrieve_all(jr)):
        _same(got, want)
    assert json.loads((tmp_path / "id_mappings.json").read_text()) == \
        {n["note_id"]: i for i, n in enumerate(jr.notes)}


def test_load_refuses_a_mismatched_signature(tmp_path):
    jr, r = _pair()
    r.save(tmp_path)
    other = EmbeddingManager(_loader(**{"embedding.dim": 32}).as_dict(), device="cpu")
    jother = JEmbeddingManager(cfg=_loader(**{"embedding.dim": 32}), singleton=False)
    assert not VectorRetriever(other).load(tmp_path)
    assert not JVectorRetriever(embedding_manager=jother).load(tmp_path)
    assert VectorRetriever(other).load(tmp_path, check_signature=False)
    assert not VectorRetriever(r.em).load(tmp_path / "missing")
    assert not JVectorRetriever(embedding_manager=jr.em).load(tmp_path / "missing")


def test_model_signature_and_check_signature():
    loader = _loader(**{"embedding.query_prefix": "q: ", "embedding.max_length": 96})
    jem = JEmbeddingManager(cfg=loader, singleton=False)
    em = EmbeddingManager(loader.as_dict(), device="cpu")
    assert em.model_signature() == jem.model_signature()
    assert em.check_signature(jem.model_signature())
    assert not em.check_signature({**jem.model_signature(), "dim": 65})
    torch_em = EmbeddingManager(_loader(**{"embedding.backend": "torch"}).as_dict(),
                                device="cpu")
    assert torch_em.model_signature()["backend"] == "torch"
    assert set(torch_em.model_signature()) == set(jem.model_signature())


@pytest.mark.parametrize("grid", [((5, 10, 20), (0.0, 0.2, 0.35, 0.5)),
                                  ((3, 8), (0.0, 0.6, 0.9))])
def test_optimize_retrieval_params_equals_the_reference(grid):
    jr, r = _pair()
    gold = [[n["note_id"] for n in row[:3]] for row in _retrieve_all(jr)]
    gold[2] = []
    want = j_optimize_retrieval_params(jr, QUERIES, gold, *grid)
    got = optimize_retrieval_params(r, QUERIES, gold, *grid)
    assert got["top_k"] == want["top_k"] and got["threshold"] == want["threshold"]
    assert got["f1"] == pytest.approx(want["f1"], abs=1e-9)
    assert (r.top_k, r.similarity_threshold) == (jr.top_k, jr.similarity_threshold)


@pytest.mark.parametrize("index_type,dtype", [("Flat", "bfloat16"), ("Flat", "float32"),
                                              ("IVFFlat", "bfloat16")])
def test_vector_index_save_load_equals_the_reference(tmp_path, index_type, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 32)).astype(np.float32)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    # the default ivf_min_corpus, which neither package saves: below it
    # IVFFlat searches Flat, the loaded index as the one it was saved from
    kw = dict(dimension=32, index_type=index_type, nlist=4, nprobe=2,
              storage_dtype=dtype)
    ji, ti = JVectorIndex(**kw), VectorIndex(**kw, device="cpu")
    ji.add(x)
    ti.add(x)
    ti.save(tmp_path / "port" / "index")
    ji.save(tmp_path / "ref" / "index")
    meta = [json.loads((tmp_path / d / "index_metadata.json").read_text())
            for d in ("port", "ref")]
    assert meta[0] == meta[1]
    # either file loads in either package and searches as the index that
    # package built from the rows (IVF clusters are each package's own)
    for d in ("port", "ref"):
        for loaded, built in ((VectorIndex.load(tmp_path / d / "index", device="cpu"), ti),
                              (JVectorIndex.load(tmp_path / d / "index"), ji)):
            assert (loaded.ntotal, loaded.storage_dtype, loaded.index_type) == \
                (300, dtype, index_type)
            s, i = loaded.search_arrays(q, 10)
            ws, wi = built.search_arrays(q, 10)
            np.testing.assert_array_equal(np.asarray(i), np.asarray(wi))
            np.testing.assert_allclose(np.asarray(s), np.asarray(ws), atol=1e-5)
    with np.load(tmp_path / "port" / "index.npz") as p, \
            np.load(tmp_path / "ref" / "index.npz") as r:
        np.testing.assert_allclose(p["embeddings"], r["embeddings"], atol=1e-7)


def test_vector_index_save_load_empty_and_options(tmp_path):
    ti = VectorIndex(dimension=16, index_type="Flat", nprobe=7, hnsw_m=8, ef_search=9,
                     device="cpu")
    ti.save(tmp_path / "idx")
    back = VectorIndex.load(tmp_path / "idx", use_kernel=False, device="cpu")
    assert (back.ntotal, back.nprobe, back.hnsw_m, back.ef_search, back.use_kernel) == \
        (0, 7, 8, 9, False)
    s, i = back.search_arrays(np.ones((2, 16), np.float32), 3)
    assert (i == -1).all()


def _small_em(tmp_path=None):
    small = EncoderConfig.small()
    cfg = {"embedding": {"backend": "torch", "dim": small.hidden_size,
                         "max_length": 32},
           "encoder": {"vocab_size": small.vocab_size, "hidden_size": small.hidden_size,
                       "num_layers": small.num_layers, "num_heads": small.num_heads,
                       "intermediate_size": small.intermediate_size,
                       "max_position": small.max_position, "dtype": "float32"}}
    return cfg


def test_load_checkpoint_reads_a_state_dict_of_the_ports_encoder(tmp_path):
    cfg = _small_em()
    src = EmbeddingManager(cfg, device="cpu", seed=1)
    dst = EmbeddingManager(cfg, device="cpu", seed=2)
    texts = ["Aurora Lane performed Blue Horizon.", "Nexus Labs was founded in 2001."]
    want = src.encode_texts(texts)
    assert not torch.allclose(dst.encode_texts(texts), want)
    torch.save(src._encoder.state_dict(), tmp_path / "enc.pt")
    assert dst.load_checkpoint(str(tmp_path / "enc.pt"))
    torch.testing.assert_close(dst.encode_texts(texts), want, rtol=0, atol=0)


def test_load_checkpoint_returns_false_when_it_cannot_read(tmp_path):
    cfg = _small_em()
    em = EmbeddingManager(cfg, device="cpu")
    before = em.encode_texts(["a note"])
    assert not em.load_checkpoint(str(tmp_path / "missing.pt"))
    (tmp_path / "junk.pt").write_bytes(b"not a checkpoint")
    assert not em.load_checkpoint(str(tmp_path / "junk.pt"))
    bad = {k: v[..., :1] for k, v in em._encoder.state_dict().items()}
    torch.save(bad, tmp_path / "bad.pt")
    assert not em.load_checkpoint(str(tmp_path / "bad.pt"))
    torch.testing.assert_close(em.encode_texts(["a note"]), before, rtol=0, atol=0)
    hashed = EmbeddingManager({"embedding": {"backend": "hash", "dim": 16}}, device="cpu")
    jhashed = JEmbeddingManager(cfg=_loader(), singleton=False)
    assert hashed.load_checkpoint(str(tmp_path / "enc.pt")) is \
        jhashed.load_checkpoint(str(tmp_path / "enc.pt")) is False
