"""The port's offline knowledge-base build against anorag_tpu's, on the CPU.

The host modules of the build are copies of the reference's with their
imports renamed: their ASTs are held equal to the originals' (the parts
that differ by design are listed with their reasons). The same inputs go
through both packages and must give the same outputs: the note generators
(rule, stub LLM, batched, parallel, enhanced), the summary auditor, the
early stop, note quality, notes_io and NER; the chunker, the incremental
plan and its result cache, ArtifactStore, the GraphML exporter; auto_k,
density_cluster and TopicClustering on seeded rows;
DocumentProcessor.process_documents on synthetic MuSiQue-style items with
the hash embedder (every artifact byte for byte, manifests and result.json
but for times and paths) and with a 2-layer, 64-wide encoder whose weights
are carried across (embeddings to 1e-5, labels and edges equal); and the
two CLIs, `main.py process` then `query`, which print the same answer.
"""
import importlib
import json
import os
import subprocess
import textwrap
import sys

import jax
import numpy as np
import pytest
import torch

from anorag_tpu.config import ConfigLoader
from anorag_tpu.doc.processor import DocumentProcessor as JDocumentProcessor
from anorag_tpu_torch.config import Config
from anorag_tpu_torch.doc.processor import DocumentProcessor
from anorag_tpu_torch.models.embedding_manager import EmbeddingManager
from anorag_tpu_torch.models.encoder import EncoderConfig, params_from_jax

from test_torch_answer import (ROOT, _DEVICE, _DEVICE_HELPERS, _TORCH,
                               assert_copy_equal)

PKGS = ("anorag_tpu", "anorag_tpu_torch")

# ------------------------------------------------- copied host modules
OFFLINE_COPIED = ("utils/ner.py llm/early_stop.py llm/notes_io.py "
                  "llm/summary_auditor.py llm/note_quality.py llm/note_generator.py "
                  "llm/parallel_note_gen.py llm/enhanced_note_generator.py "
                  "doc/chunker.py doc/consistency.py doc/incremental.py "
                  "graph/exporter.py index/embedding_strategy.py index/store.py "
                  "validators/note_validator.py doc/clustering.py "
                  "doc/processor.py").split()

_VERSION = "stamps the port's __version__, held equal to the reference's"
OFFLINE_DIFFERS = {
    "index/store.py": {"ArtifactStore.is_fresh": _VERSION,
                       "ArtifactStore.write_manifest": _VERSION},
    "index/embedding_strategy.py": {
        "JaxEmbeddingModel.__init__": "the port's Config and EmbeddingManager "
                                      "on the given device; backend jax read "
                                      "as the port's torch encoder",
        "JaxEmbeddingModel.encode": "numpy rows from the port's tensor",
        "create_embedding_model": _DEVICE},
    "doc/clustering.py": {
        **_TORCH, **_DEVICE_HELPERS,
        "_pairwise_sq_dists": "torch.matmul on the rows' device; returns the "
                              "(N, N) tensor there",
        "find_optimal_eps": "torch.topk in place of lax.top_k",
        "density_cluster": "thresholds on the device, walks the cores on "
                           "the host",
        "TopicClustering.__init__": _DEVICE,
        "TopicClustering.cluster_notes": "moves the embeddings to the device "
                                         "and brings the labels back"},
    "doc/processor.py": {
        **_TORCH, **_DEVICE_HELPERS,
        "DocumentProcessor.__init__": _DEVICE,
        "DocumentProcessor.process_documents": "the embeddings stay a tensor "
            "on the device; embeddings.npy is written from it as f32 numpy "
            "and a cache hit loads it back there"},
}


@pytest.mark.parametrize("rel", OFFLINE_COPIED)
def test_copied_offline_module_equals_the_original(rel):
    assert_copy_equal(rel, OFFLINE_DIFFERS.get(rel, {}))


def test_version_equals_the_references():
    import anorag_tpu
    import anorag_tpu_torch

    assert anorag_tpu_torch.__version__ == anorag_tpu.__version__ == "0.3.3"


OFFLINE_KEYS = ("chunking", "clustering", "graph.pagerank",
                "graph.relation_extraction", "enhanced_relation_extraction",
                "atomic_note_generation", "notes_llm", "storage", "note_keys",
                "quality_filter", "note_completeness", "note_quality",
                "evaluation")


@pytest.mark.parametrize("key", OFFLINE_KEYS)
def test_offline_config_defaults_equal_the_reference(key):
    assert Config().get(key) == ConfigLoader(auto_load=False).get(key)


# ------------------------------------------------- helpers: both packages
def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _cfg(pkg, sets=None):
    cfg = ConfigLoader(auto_load=False) if pkg == "anorag_tpu" else Config()
    for k, v in (sets or {}).items():
        cfg.set(k, v)
    return cfg


def _llm(pkg, replies):
    """LocalLLM over the ollama wire shape answering replies[i] to call i
    (the last one from then on); None in replies fails the call."""
    calls = {"n": 0}

    def transport(url, payload, timeout):
        reply = replies[min(calls["n"], len(replies) - 1)]
        calls["n"] += 1
        if reply is None:
            raise ConnectionError("endpoint down")
        return {"response": reply}

    return _mod(pkg, "llm.local_llm").LocalLLM(
        cfg=_cfg(pkg, {"llm.provider": "ollama"}), transport=transport)


def _dir(tmp_path, pkg):
    """A directory of each package's scenario, the names of equal length."""
    return tmp_path / {"anorag_tpu": "ref", "anorag_tpu_torch": "prt"}[pkg]


def _both(scenario):
    """scenario(pkg) for the reference and the port; results equal."""
    want, got = (scenario(pkg) for pkg in PKGS)
    assert got == want
    return got


def _chunk(**kw):
    return {"doc_id": "d1", "chunk_index": 0, "title": "Doc Title",
            "paragraph_idx": 3,
            "text": "Aurora Lane performed Blue Horizon. The album sold a million copies.",
            "sentences": ["Aurora Lane performed Blue Horizon.",
                          "The album sold a million copies."], **kw}


_REPLY = json.dumps([{
    "text": "Aurora Lane performed the song Blue Horizon.",
    "entities": ["Aurora Lane", "Blue Horizon"],
    "head_key": "Blue Horizon", "rel": "performed by", "tail_key": "Aurora Lane",
    "source_sent_ids": [0], "salience": 0.9}])
_TWO = json.dumps([
    {"text": "Aurora Lane performed the song Blue Horizon.",
     "entities": ["Aurora Lane"], "source_sent_ids": [0], "salience": 0.9},
    {"text": "The album sold a million copies worldwide.",
     "entities": ["Blue Horizon"], "source_sent_ids": [1], "salience": 0.8}])
_GHOST = json.dumps([{"text": "A fabricated fact sentence here today.",
                      "source_sent_ids": [7], "salience": 0.9}])

# (replies, config sets, chunks)
NOTE_CASES = {
    "happy": ([_REPLY], {}, [_chunk()]),
    "sentinel": (["~"], {}, [_chunk()]),
    "rule_fallback": (["not json at all {{{"], {}, [_chunk()]),
    "sent_id_violation": ([_GHOST], {"notes_llm.grounding.enabled": False},
                          [_chunk(sentence_ids=[0, 1])]),
    "batched_mixed": (["~", "{{{ not json", "still bad"], {},
                      [_chunk(), _chunk(chunk_index=1)]),
    "sequential": ([_REPLY], {"notes_llm.batch.enabled": False},
                   [_chunk(), _chunk(chunk_index=1, paragraph_idx=5)]),
    "two_notes": ([_TWO], {}, [_chunk(), _chunk(chunk_index=2, paragraph_idx=4)]),
}


@pytest.mark.parametrize("case", sorted(NOTE_CASES))
def test_note_generator_with_a_stub_llm_equals_the_reference(case):
    replies, sets, chunks = NOTE_CASES[case]

    def run(pkg):
        gen = _mod(pkg, "llm.note_generator").AtomicNoteGenerator(
            _llm(pkg, replies), _cfg(pkg, sets))
        return gen.generate_atomic_notes(chunks), dict(gen.stats)

    notes, _ = _both(run)
    assert case in ("sentinel", "sent_id_violation") or notes


def test_parallel_note_generators_equal_the_reference():
    def run(pkg):
        par = _mod(pkg, "llm.parallel_note_gen")
        task = par.ParallelTaskAtomicNoteGenerator(
            [_llm(pkg, [None]), _llm(pkg, [_REPLY])], _cfg(pkg, {"llm.provider": "ollama"}))
        quality = par.ParallelAtomicNoteGenerator(
            [_llm(pkg, ["~"]), _llm(pkg, [_TWO])], _cfg(pkg),
            strategy="quality_selection")
        return (sorted(task.generate_atomic_notes([_chunk(), _chunk(chunk_index=1)]),
                       key=lambda n: n["note_id"]),
                quality.generate_atomic_notes([_chunk()]))

    task, quality = _both(run)
    assert task and quality


@pytest.mark.parametrize("audit", [False, True])
def test_enhanced_note_generator_equals_the_reference(audit):
    reply = json.dumps([{
        "text": "Blue Horizon is performed by Aurora Lane.",
        "entities": ["Blue Horizon", "Aurora Lane"],
        "head_key": "Blue Horizon", "rel": "performed_by", "tail_key": "Aurora Lane",
        "source_sent_ids": [0], "salience": 0.9}])
    chunk = {"doc_id": "d", "chunk_index": 0, "title": "Blue Horizon (album)",
             "paragraph_idx": 0, "text": "Blue Horizon is performed by Aurora Lane.",
             "sentences": ["Blue Horizon is performed by Aurora Lane."]}
    sets = {"llm.provider": "ollama", "note_quality.noise_filter.enabled": True,
            "note_quality.related_notes.enabled": True}

    def run(pkg):
        gen = _mod(pkg, "llm.enhanced_note_generator").EnhancedAtomicNoteGenerator(
            _llm(pkg, [reply]), _cfg(pkg, sets), audit=audit)
        return gen.generate_for_chunk(chunk), gen.generate_atomic_notes([chunk, chunk])

    assert _both(run)[0]


def test_summary_auditor_and_early_stop_equal_the_reference():
    note = {"note_id": "n", "content": "Aurora Lane performed Blue Horizon.",
            "entities": ["Aurora Lane", "Blue Horizon"]}
    source = ("Aurora Lane performed Blue Horizon with Marcus Webb in Denver. "
              "The album sold a million copies.")

    def run(pkg):
        aud = _mod(pkg, "llm.summary_auditor").SummaryAuditor
        es = _mod(pkg, "llm.early_stop").StreamingEarlyStop()
        verdict = json.dumps({"missing": ["Marcus Webb"], "ok": False})
        return (aud().audit_note(source, note),
                aud(llm=_llm(pkg, [verdict]), missing_ratio_threshold=0.2)
                .audit_note(source, note),
                aud().audit_batch([(source, note), ("Denver.", note)]),
                es.consume(iter(["~", "ignored"])), es.consume(iter(["real ", "text"])),
                es.is_empty_result(" ~ "), es.is_empty_result("a note"))

    _both(run)


def test_note_quality_equals_the_reference(tmp_path):
    notes = [
        {"note_id": "n0", "content": "Aurora Lane created Blue Horizon in 1990.",
         "entities": ["Aurora Lane", "Blue Horizon"], "importance_score": 0.8},
        {"note_id": "n1", "content": "Blue Horizon was created by Aurora Lane.",
         "entities": ["Aurora Lane", "Blue Horizon"]},
        {"note_id": "n2", "content": "Quantum physics studies subatomic particles.",
         "entities": ["Quantum"]},
        {"note_id": "n3", "content": "...", "entities": []},
        {"note_id": "n4", "content": "This text mentions nothing that its entity list claims.",
         "entities": ["Zanzibar Fruitbat"], "importance_score": 0.1},
    ]
    chunks = [{"chunk_index": 0,
               "text": ("Aurora Lane created the famous album Blue Horizon. "
                        "The album sold two million copies worldwide after release.")},
              {"chunk_index": 1,
               "text": "Marcus Webb directed the movie Silent River in Montana."}]
    covered = [{"note_id": "a", "chunk_index": 0,
                "content": "Aurora Lane created the famous album Blue Horizon.",
                "raw_span": "Aurora Lane created the famous album Blue Horizon."}]

    def run(pkg):
        q = _mod(pkg, "llm.note_quality")
        d = _dir(tmp_path, pkg)
        kept, dropped = q.EnhancedNoiseFilter(usefulness_threshold=0.5).filter_notes(notes)
        cov = q.evaluate_note_coverage(chunks, covered, threshold=0.6,
                                       min_sentence_tokens=4,
                                       report_path=str(d / "cov.json"),
                                       missing_path=str(d / "missing.jsonl"))
        return (q.NoteSimilarityCalculator(similarity_threshold=0.3,
                                           max_related_notes=2).find_related_notes(notes),
                kept, dropped, cov, (d / "cov.json").read_text(),
                (d / "missing.jsonl").read_text())

    _both(run)


def test_notes_io_and_ner_equal_the_reference(tmp_path):
    text = ("Aurora Lane was born in Denver in 1971. She founded Blue Horizon "
            "Records with Marcus Webb, and IBM bought it in March 1999.")

    def run(pkg):
        io = _mod(pkg, "llm.notes_io")
        path = _dir(tmp_path, pkg) / "notes.jsonl"
        with io.NoteJsonlWriter(path) as w:
            w.write_many([{"note_id": "a", "content": "x"}, {"note_id": "b"}])
        with io.NoteJsonlWriter(path) as w:
            w.write({"note_id": "c"})
            ids = w.existing_ids()
        stats = io.NotesStatsLogger()
        for n in ({"note_id": "a", "entities": ["A"], "rel": "born_in"},
                  {"note_id": "b", "entities": []}):
            stats.record_note(n)
        stats.record_outcome("rule_fallback", 2)
        report = stats.report()
        report.pop("elapsed_s", None)
        ner = _mod(pkg, "utils.ner").EnhancedNER(use_spacy=False)
        return (path.read_text(), sorted(ids), report, ner.extract(text),
                ner.extract_typed(text), ner.entity_diff(text, "Aurora Lane founded it."))

    _both(run)


# ------------------------------------------------- chunks, caches, exporter
@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """Three synthetic MuSiQue-style items (53 paragraphs) from the repo's
    generator."""
    path = tmp_path_factory.mktemp("synth") / "synth.jsonl"
    subprocess.run([sys.executable, str(ROOT / "scripts" / "gen_synth_musique.py"),
                    str(path), "--n", "3", "--seed", "0"], check=True,
                   stdout=subprocess.DEVNULL)
    return path


def test_chunker_and_rule_notes_equal_the_reference(synth):
    def run(pkg):
        cfg = _cfg(pkg)
        chunks = _mod(pkg, "doc.chunker").DocumentChunker(
            max_chunk_chars=300, overlap_chars=40).chunk_file(synth)
        gen = _mod(pkg, "doc.processor")._RuleNoteGenerator(cfg)
        notes = _mod(pkg, "llm.note_generator").resolve_note_abbreviations(
            gen.generate_atomic_notes(chunks))
        report = _mod(pkg, "doc.consistency").ConsistencyChecker().check_consistency(
            notes + notes[:1], np.zeros((len(notes), 4)), {"nodes": [{"id": "x"}]},
            {"labels": [0]})
        return chunks, notes, report

    chunks, notes, report = _both(run)
    assert len(chunks) > 10 and len(notes) > len(chunks) and not report["consistent"]


def test_incremental_plan_and_result_cache_equal_the_reference(tmp_path):
    def run(pkg):
        d = _dir(tmp_path, pkg)
        d.mkdir()
        a, b, c = (d / n for n in ("a.txt", "b.txt", "c.txt"))
        for f in (a, b, c):
            f.write_text(f.name)
        inc = _mod(pkg, "doc.incremental").IncrementalProcessor(d / "cache")
        inc.add_dependency(b, [a])
        inc.add_dependency(c, [b])
        out = []

        def plan(files):
            p = inc.get_processing_plan(files)
            out.append({k: [str(x).replace(str(d), "") for x in v]
                        if isinstance(v, list) else v
                        for k, v in p.items() if k != "_hashes"})
            return p

        inc.commit(plan([a, b, c])["_hashes"])
        plan([a, b, c])
        a.write_text("changed")
        plan([a, b, c])
        inc.update_file_cache(a, {"notes": 3})
        inc.update_file_cache(b, {"notes": 5})
        out.append(inc.get_cached_result(b))
        b.unlink()
        v = inc.validate_cache_integrity()
        out.append(sorted(json.dumps(v, sort_keys=True, default=str)
                          .replace(str(d), "")))
        inc.repair_cache(v)
        out.append(inc.validate_cache_integrity()["ok"])
        out.append({k: v for k, v in inc.get_cache_statistics().items()
                    if "path" not in k and "dir" not in k})
        out.append([str(x).replace(str(d), "")
                    for x in inc.optimize_processing_order([str(c), str(a)])])
        return out

    _both(run)


def test_artifact_store_hits_and_misses_equal_the_reference(tmp_path):
    def run(pkg):
        store = _mod(pkg, "index.store").ArtifactStore(_dir(tmp_path, pkg))
        built = []

        def cached(name, cfg, h, value, force=False):
            return store.cached(name, cfg, h, build=lambda: built.append(name) or value,
                                save=lambda v: store.save_json(name, v, cfg, h),
                                load=lambda: store.load_json(name), force=force)

        got = [cached("a", {"x": 1}, "h", [1, 2]), cached("a", {"x": 1}, "h", [9]),
               cached("a", {"x": 2}, "h", [3]), cached("a", {"x": 2}, "g", [4]),
               cached("a", {"x": 2}, "g", [5], force=True), cached("a", {"x": 2}, "g", [6])]
        store.save_arrays("arr", {"y": 1}, "h", v=np.arange(4))
        manifest = json.loads((_dir(tmp_path, pkg) / "arr.manifest.json").read_text())
        manifest.pop("created_at")
        return (got, built, store.is_fresh("arr", {"y": 1}, "h"),
                store.is_fresh("arr", {"y": 2}, "h"), manifest,
                store.load_arrays("arr")["v"].tolist())

    got, built, *_ = _both(run)
    assert built == ["a", "a", "a", "a"] and got[1] == [1, 2]


def test_embedding_strategy_registry_equals_the_reference(tmp_path):
    def run(pkg):
        es = _mod(pkg, "index.embedding_strategy")
        cfg = es.EmbeddingConfig(backend="hash", dim=64)
        reg = es.IndexVersionRegistry(_dir(tmp_path, pkg) / "versions.json")
        before = reg.is_compatible(cfg)
        entry = reg.register(cfg, "idx", 100)
        entry.pop("created_at")
        return (cfg.signature, es.EmbeddingConfig().signature,
                es.create_embedding_model(cfg).encode(["hello world"]).tolist(),
                before, entry, reg.is_compatible(cfg),
                reg.is_compatible(es.EmbeddingConfig(backend="hash", dim=128)))

    _both(run)


def test_jax_embedding_model_is_the_ports_encoder():
    from anorag_tpu_torch.index.embedding_strategy import (EmbeddingConfig,
                                                           JaxEmbeddingModel,
                                                           create_embedding_model)

    model = create_embedding_model(EmbeddingConfig(), device="cpu")
    assert (model._em.backend, model._em.device.type) == ("torch", "cpu")
    small = EncoderConfig.small()
    em = EmbeddingManager({"embedding": {"dim": small.hidden_size, "max_length": 32},
                           "encoder": {**small.__dict__, "dtype": "float32"}}, device="cpu")
    out = JaxEmbeddingModel(EmbeddingConfig(dim=small.hidden_size), manager=em).encode(
        ["hello world", "a note"])
    assert isinstance(out, np.ndarray) and out.shape == (2, small.hidden_size)
    np.testing.assert_allclose(out, em.encode_texts(["hello world", "a note"]).numpy())


def test_graphml_export_equals_the_reference(tmp_path):
    notes = [{"note_id": f"n{i}", "title": f"T{i}", "content": f"c {i}",
              "entities": ["A", f"E{i}"], "score": 0.5 * i, "flag": bool(i % 2),
              "none": None, "meta": {"k": i}} for i in range(4)]
    rels = [{"source": 0, "target": 1, "weight": 0.8, "relation_type": "topic"},
            {"source": 2, "target": 3, "weight": 1.0, "relation_type": None}]

    def run(pkg):
        gi = _mod(pkg, "graph.graph_index").GraphIndex(
            **({} if pkg == "anorag_tpu" else {"device": "cpu"}))
        gi.notes, gi.edge_meta = notes, rels
        path = _dir(tmp_path, pkg) / "g.graphml"
        ok = _mod(pkg, "graph.exporter").export_graphml(gi, path)
        return ok, path.read_bytes()

    assert _both(run)[0]


# ------------------------------------------------- clustering
def _blobs(n=240, d=32, centres=5, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centres, d)).astype(np.float32) * 4
    x = c[rng.integers(0, centres, n)] + rng.normal(size=(n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auto_k_picks_the_references_k(seed):
    from anorag_tpu.ops.kmeans import auto_k as j_auto_k
    from anorag_tpu_torch.ops.kmeans import auto_k

    x = _blobs(seed=seed, centres=3 + seed)
    want = j_auto_k(x, max_k=12, iters=7, seed=seed)
    assert auto_k(x, max_k=12, iters=7, seed=seed) == want
    assert auto_k(torch.from_numpy(x), max_k=12, iters=7, seed=seed) == want


@pytest.mark.parametrize("min_samples,eps", [(3, None), (4, None), (3, 0.6)])
def test_density_cluster_equals_the_reference(min_samples, eps):
    from anorag_tpu.doc.clustering import density_cluster as j_density
    from anorag_tpu.doc.clustering import find_optimal_eps as j_eps
    from anorag_tpu.doc.clustering import _pairwise_sq_dists as j_sq
    from anorag_tpu_torch.doc.clustering import (_pairwise_sq_dists, density_cluster,
                                                 find_optimal_eps)

    x = _blobs(n=150, seed=3)
    sq = _pairwise_sq_dists(torch.from_numpy(x))
    np.testing.assert_allclose(sq.numpy(), j_sq(x), atol=1e-5)
    assert find_optimal_eps(sq, min_samples) == pytest.approx(
        j_eps(j_sq(x), min_samples), abs=1e-6)
    labels, e = density_cluster(x, min_samples=min_samples, eps=eps)
    want, we = j_density(x, min_samples=min_samples, eps=eps)
    assert e == pytest.approx(we, abs=1e-6)
    np.testing.assert_array_equal(labels, want)
    assert len(set(labels.tolist()) - {-1}) >= 2


@pytest.mark.parametrize("kw", [{}, {"n_clusters": 4}, {"noise_threshold": 0.9},
                                {"method": "dbscan"}, {"max_clusters": 1}])
def test_topic_clustering_equals_the_reference(kw):
    from anorag_tpu.doc.clustering import TopicClustering as JTopicClustering
    from anorag_tpu_torch.doc.clustering import TopicClustering

    x = _blobs(n=120, seed=4)
    notes = [{"note_id": f"n{i}", "title": f"topic {i % 7}",
              "content": f"word{i % 5} shared words here {i % 3}"} for i in range(len(x))]
    want = JTopicClustering(**kw).cluster_notes(notes, x)
    eps = want.pop("eps", None)      # the k-distance knee, rounded differently
    for rows in (x, torch.from_numpy(x)):
        got = TopicClustering(**kw, device="cpu").cluster_notes(notes, rows)
        assert got.pop("eps", None) == pytest.approx(eps, abs=1e-6)
        assert got == want
    for n in (0, 1):
        assert TopicClustering(device="cpu").cluster_notes(notes[:n], x[:n]) == \
            JTopicClustering().cluster_notes(notes[:n], x[:n])


# ------------------------------------------------- the document processor
_ARTIFACTS = ("chunks.jsonl", "atomic_notes.json", "embeddings.npy", "clustering.json",
              "graph.json", "graph.graphml", "consistency_report.json",
              "graph.json_mappings.json")


def _hash_sets():
    return {"embedding.backend": "hash", "embedding.dim": 128,
            "vector_store.index_type": "Flat", "tpu.sharded_search": "off"}


def _strip(result, work):
    out = json.loads(json.dumps(result, default=str).replace(str(work), "WORK"))
    out["processing_stats"].pop("elapsed_s")
    return out


def _assert_same_work_dirs(jwork, twork, emb_atol=0.0):
    for name in _ARTIFACTS:
        if name == "embeddings.npy" and emb_atol:
            np.testing.assert_allclose(np.load(twork / name), np.load(jwork / name),
                                       atol=emb_atol, rtol=0)
        else:
            assert (twork / name).read_bytes() == (jwork / name).read_bytes(), name
    with np.load(jwork / "graph.json_embeddings.npz") as j, \
            np.load(twork / "graph.json_embeddings.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        np.testing.assert_allclose(t["embeddings"], j["embeddings"], atol=emb_atol, rtol=0)
        np.testing.assert_allclose(t["centrality"], j["centrality"], rtol=1e-6)
    for stage in ("chunks", "atomic_notes", "embeddings", "clustering", "graph"):
        j, t = (json.loads((w / f"{stage}.manifest.json").read_text())
                for w in (jwork, twork))
        j.pop("created_at"), t.pop("created_at")
        assert t == j, stage
    j, t = (json.loads((w / "result.json").read_text()) for w in (jwork, twork))
    assert _strip(t, twork) == _strip(j, jwork)


def test_process_documents_equals_the_reference_hash_backend(synth, tmp_path):
    loader = _cfg("anorag_tpu", _hash_sets())
    jdp = JDocumentProcessor(tmp_path / "j", cfg=loader)
    dp = DocumentProcessor(tmp_path / "t", cfg=Config(loader.as_dict()), device="cpu")
    want = jdp.process_documents(file_paths=[str(synth)])
    got = dp.process_documents(file_paths=[str(synth)])
    assert _strip(got, tmp_path / "t") == _strip(want, tmp_path / "j")
    assert got["consistency"]["consistent"] and len(got["atomic_notes"]) > 100
    _assert_same_work_dirs(tmp_path / "j", tmp_path / "t")
    # again: every stage a cache hit, the artifacts as they were
    before = {n: (tmp_path / "t" / n).read_bytes() for n in _ARTIFACTS}
    built = []
    again = DocumentProcessor(tmp_path / "t", cfg=Config(loader.as_dict()), device="cpu")
    cached = again.store.cached

    def counting(name, cfg, input_hash, build, save, load, force=False):
        return cached(name, cfg, input_hash, lambda: built.append(name) or build(),
                      save, load, force)

    again.store.cached = counting
    second = again.process_documents(file_paths=[str(synth)])
    assert built == [] and isinstance(second["graph_data"], dict)
    assert {n: (tmp_path / "t" / n).read_bytes() for n in _ARTIFACTS} == before
    assert JDocumentProcessor(tmp_path / "j", cfg=loader).process_documents(
        file_paths=[str(synth)])["processing_stats"]["n_notes"] == \
        second["processing_stats"]["n_notes"]


def test_process_documents_takes_documents_and_force(tmp_path):
    docs = [{"id": "d1", "title": "Blue Horizon",
             "text": "Blue Horizon is an album by Aurora Lane. It was released in 1990.\n\n"
                     "Aurora Lane was born in Denver. She married Marcus Webb."},
            {"id": "d2", "title": "Marcus Webb",
             "text": "Marcus Webb founded Nexus Labs in 2001. Nexus Labs is located in Austin."}]
    loader = _cfg("anorag_tpu", _hash_sets())
    want = JDocumentProcessor(tmp_path / "j", cfg=loader).process_documents(
        documents=docs, force_reprocess=True)
    got = DocumentProcessor(tmp_path / "t", cfg=Config(loader.as_dict()),
                            device="cpu").process_documents(documents=docs,
                                                            force_reprocess=True)
    assert _strip(got, tmp_path / "t") == _strip(want, tmp_path / "j")
    _assert_same_work_dirs(tmp_path / "j", tmp_path / "t")


def test_process_documents_equals_the_reference_encoder_backend(synth, tmp_path):
    """A 2-layer, 64-wide encoder with the JAX weights carried across: the
    embeddings agree to 1e-5, the cluster labels and the graph's edges are
    equal."""
    enc = {"vocab_size": 1024, "hidden_size": 64, "num_layers": 2, "num_heads": 4,
           "intermediate_size": 128, "max_position": 128, "dtype": "float32",
           "pooling": "mean"}
    sets = {**_hash_sets(), "embedding.backend": "jax", "embedding.model_name": "",
            "embedding.dim": 64, "embedding.max_length": 128,
            **{f"encoder.{k}": v for k, v in enc.items()}}
    loader = _cfg("anorag_tpu", sets)
    jdp = JDocumentProcessor(tmp_path / "j", cfg=loader)
    jdp.em._ensure_backend()
    port_cfg = loader.as_dict()
    port_cfg["embedding"]["backend"] = "torch"
    em = EmbeddingManager(port_cfg, device="cpu")
    em.load_encoder_state(params_from_jax(jax.tree.map(np.asarray, jdp.em._params),
                                          EncoderConfig.from_config(enc)))
    dp = DocumentProcessor(tmp_path / "t", cfg=Config(port_cfg), embedding_manager=em,
                           device="cpu")
    want = jdp.process_documents(file_paths=[str(synth)])
    got = dp.process_documents(file_paths=[str(synth)])
    np.testing.assert_allclose(np.load(tmp_path / "t" / "embeddings.npy"),
                               np.load(tmp_path / "j" / "embeddings.npy"), atol=1e-5, rtol=0)
    for name in ("chunks.jsonl", "atomic_notes.json", "clustering.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    edges = [[(lk["source"], lk["target"], lk["relation_type"]) for lk in r["graph_data"]["links"]]
             for r in (got, want)]
    assert edges[0] == edges[1]
    np.testing.assert_allclose([lk["weight"] for lk in got["graph_data"]["links"]],
                               [lk["weight"] for lk in want["graph_data"]["links"]],
                               atol=1e-5, rtol=0)
    assert got["consistency"] == want["consistency"]


# ------------------------------------------------- the CLIs
def _cli(pkg_main, tmp_path, args, device_sets):
    cfg = tmp_path / f"{pkg_main.replace('/', '_')}.yaml"
    import yaml

    cfg.write_text(yaml.safe_dump(device_sets))
    cmd = ([sys.executable, str(ROOT / "main.py")] if pkg_main == "main.py"
           else [sys.executable, "-m", "anorag_tpu_torch.main"])
    env = {**os.environ, "PYTHONPATH": str(ROOT), "PYTHONHASHSEED": "0",
           "JAX_PLATFORMS": "cpu"}
    return subprocess.run(cmd + ["--config", str(cfg), *args], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)


def test_main_process_then_query_equal_the_reference_cli(synth, tmp_path):
    question = json.loads(synth.read_text().splitlines()[0])["question"]
    out = {}
    for pkg_main, root in (("main.py", "res_jax"), ("anorag_tpu_torch", "res_torch")):
        sets = {"system": {"device": "cpu"}, "embedding": {"backend": "hash", "dim": 128},
                "vector_store": {"index_type": "Flat"}, "tpu": {"sharded_search": "off"},
                "storage": {"result_root": f"./{root}"}}
        p = _cli(pkg_main, tmp_path, ["process", str(synth), "--no-llm"], sets)
        assert p.returncode == 0, p.stderr[-2000:]
        assert p.stdout.startswith(f"processed -> {root}/1: {{'n_chunks': ")
        q = _cli(pkg_main, tmp_path, ["query", question, "--work-dir", f"{root}/1",
                                      "--no-llm"], sets)
        assert q.returncode == 0, q.stderr[-2000:]
        missing = _cli(pkg_main, tmp_path, ["query", question, "--work-dir",
                                            f"{root}/9"], sets)
        out[pkg_main] = (p.stdout.split(": ", 1)[1].split("'elapsed_s'")[0],
                         q.stdout, missing.returncode, missing.stderr.strip().splitlines()[-1])
    assert out["anorag_tpu_torch"] == out["main.py"]
    assert out["main.py"][1].startswith("answer: ")
    for name in _ARTIFACTS:
        assert (tmp_path / "res_torch/1" / name).read_bytes() == \
            (tmp_path / "res_jax/1" / name).read_bytes(), name


def test_main_process_parallel_raises(synth, tmp_path):
    from anorag_tpu_torch.main import main

    cfg = Config({"system": {"device": "cpu"}, "storage": {"result_root": str(tmp_path)}})
    with pytest.raises(NotImplementedError, match="sharded branch"):
        main(["process", str(synth), str(synth), "--parallel", "--no-llm"], cfg)
    with pytest.raises(NotImplementedError):
        main(["process", str(synth), "--parallel", "--no-llm"], cfg)
    assert not (tmp_path / "1" / "atomic_notes.json").exists()


def test_main_config_device():
    from anorag_tpu_torch.main import config_device

    for want, device in (("cpu", "cpu"), ("CPU", "cpu"), ("tpu", "cuda"),
                         ("gpu", "cuda"), ("cuda", "cuda"), (None, "cuda")):
        assert config_device(Config({"system": {"device": want}})) == device
    assert config_device(Config()) == "cuda"


def test_document_processor_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DocumentProcessor("unused", cfg=Config())


def test_offline_build_runs_with_jax_and_yaml_blocked(synth, tmp_path):
    """As on the card's machine (no JAX, no PyYAML): main process then
    query in-process with a Config, as chip_smoke.py's phase offline
    calls them; a --config then exits naming PyYAML."""
    code = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None
        sys.modules["anorag_tpu"] = None
        sys.modules["yaml"] = None
        from anorag_tpu_torch.config import Config
        from anorag_tpu_torch.main import main
        cfg = Config({{"system": {{"device": "cpu"}},
                      "embedding": {{"backend": "hash", "dim": 64}},
                      "vector_store": {{"index_type": "Flat"}},
                      "storage": {{"result_root": {str(tmp_path / "res")!r}}}}})
        assert main(["process", {str(synth)!r}, "--no-llm"], cfg) == 0
        assert main(["query", "Who is the spouse of the performer of Prilu Garden?",
                     "--no-llm"], cfg) == 0
        try:
            main(["--config", "x.yaml", "query", "q"], cfg)
        except SystemExit as e:
            assert "PyYAML" in str(e), e
        else:
            raise AssertionError("--config ran without PyYAML")
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith(f"processed -> {tmp_path / 'res' / '1'}: ")
    assert "\nanswer: " in out.stdout and "(method: " in out.stdout
