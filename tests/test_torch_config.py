"""The port's config package (anorag_tpu_torch/config/) against the
reference's (anorag_tpu/config/): the copied modules, the defaults, the
loader on the repo's config.yaml and on generated YAML (every alias pair,
unknown and deprecated keys), and the port's own YAML reader against
PyYAML's safe_load. Equality is exact throughout."""
from __future__ import annotations

import importlib
import json
import string
import subprocess
import sys
import textwrap

import pytest
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from anorag_tpu.config import ConfigLoader as JConfigLoader
from anorag_tpu.config import defaults as jdefaults
from anorag_tpu_torch.config import Config, ConfigLoader, as_config, defaults
from anorag_tpu_torch.config.loader import get_path, set_path
from anorag_tpu_torch.config.yaml_subset import safe_load

from test_torch_answer import ROOT, assert_copy_equal

tconfig = importlib.import_module("anorag_tpu_torch.config")

CONFIG_COPIED = ("config/defaults.py", "config/loader.py")
_ADDED = "the port's own, added"
CONFIG_DIFFERS = {
    "config/defaults.py": {
        "DEFAULT_CONFIG": "system.device cuda and embedding.backend torch, "
                          "the values PORT_VALUES names",
        "PORT_VALUES": "names the port's two values",
    },
    "config/loader.py": {
        "import yaml": "PyYAML, which the port's reader replaces",
        "from anorag_tpu_torch.config.yaml_subset import safe_load": "the port's reader",
        "from typing import Any, Dict, List, Optional, Tuple": "the original's "
            "typing import, which the next replaces",
        "from typing import Any, Dict, List, Mapping, Optional, Tuple": "Mapping too",
        "ConfigLoader.load_config": "reads the file with the port's reader",
        "Config": _ADDED, "as_config": _ADDED,
    },
}


@pytest.mark.parametrize("rel", CONFIG_COPIED)
def test_copied_config_module_equals_the_original(rel):
    assert_copy_equal(rel, CONFIG_DIFFERS[rel])


def test_package_exports_the_references_names_and_the_ports():
    jpkg = importlib.import_module("anorag_tpu.config")
    assert set(tconfig.__all__) == set(jpkg.__all__) | {"Config", "as_config", "DEFAULTS"}
    assert tconfig.DEFAULTS is tconfig.DEFAULT_CONFIG


def _as_reference(tree):
    """A port tree with the reference's values at PORT_VALUES."""
    tree = json.loads(json.dumps(tree))
    for key in defaults.PORT_VALUES:
        set_path(tree, key, get_path(json.loads(json.dumps(jdefaults.default_config())), key))
    return tree


def test_defaults_equal_the_references_but_the_named_values():
    assert defaults.PORT_VALUES == {"system.device": "cuda", "embedding.backend": "torch"}
    port, ref = defaults.default_config(), jdefaults.default_config()
    for key, value in defaults.PORT_VALUES.items():
        assert get_path(port, key) == value != get_path(ref, key)
    assert _as_reference(port) == json.loads(json.dumps(ref))
    assert defaults.DEPRECATED_KEYS == jdefaults.DEPRECATED_KEYS
    assert defaults.ALIAS_PAIRS == jdefaults.ALIAS_PAIRS
    assert defaults.default_config() is not defaults.DEFAULT_CONFIG


def _both(path):
    return JConfigLoader(str(path)), ConfigLoader(str(path))


def _assert_same(j, t):
    assert _as_reference(t.as_dict()) == json.loads(json.dumps(j.as_dict()))
    assert t.report() == j.report()
    assert t.unknown_keys == j.unknown_keys
    assert t.deprecated_hits == j.deprecated_hits


def test_loader_on_the_repos_config_yaml_equals_the_references():
    j, t = _both(ROOT / "config.yaml")
    _assert_same(j, t)
    # the file sets both alias sides: hybrid_search, the new one, wins
    assert t.get("hybrid_search.weights") == {"dense": 1.0, "bm25": 0.5, "graph": 0.5,
                                              "path": 0.1}
    assert t.get("retrieval.hybrid.weights") == t.get("hybrid_search.weights")
    assert t.get("hybrid_search.fusion_method") == "linear"
    assert t.get("system.device") == "tpu" and t.get("embedding.backend") == "jax"


def test_loader_reports_unknown_and_deprecated_keys_as_the_reference(tmp_path):
    user = {"dispatcher": {"final_semantic_count": 3},
            "hybrid_search": {"linear": {"vector_weight": 0.9}, "nope": 1},
            "no_such_section": {"x": 1}, "retrieval": {"hybrid": {"rrf_k": 30}},
            "graph": {"edge": {"bogus": True}}, "cor": {"anything": [1, 2]}}
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(user))
    j, t = _both(path)
    _assert_same(j, t)
    assert t.unknown_keys and len(t.deprecated_hits) == 2
    for obj in (j, t):          # get / set / reset
        obj.set("a.b.c", 5)
        assert obj.get("a.b.c") == 5 and obj.get("a.b.zz", "d") == "d"
        obj.reset()
    _assert_same(j, t)


def _alias_value(path, side):
    """A value for an alias path: a sub-dict where the default is one."""
    mark = {"legacy": 11, "new": 22}[side]
    if isinstance(get_path(jdefaults.default_config(), path), dict):
        return {"k_alias_test": mark}
    return mark


ALIAS_CASES = [(legacy, new, sides) for legacy, new in jdefaults.ALIAS_PAIRS
               for sides in (("legacy",), ("new",), ("legacy", "new"))]


@pytest.mark.parametrize("legacy,new,sides", ALIAS_CASES,
                         ids=[f"{a}~{b}~{'+'.join(s)}" for a, b, s in ALIAS_CASES])
def test_alias_pair_synchronised_as_the_reference(tmp_path, legacy, new, sides):
    user: dict = {}
    for side in sides:
        set_path(user, legacy if side == "legacy" else new, _alias_value(
            legacy if side == "legacy" else new, side))
    path = tmp_path / "alias.yaml"
    path.write_text(yaml.safe_dump(user))
    j, t = _both(path)
    _assert_same(j, t)
    winner = "new" if "new" in sides else "legacy"
    want = _alias_value(new if winner == "new" else legacy, winner)
    for obj in (j, t):
        for p in (legacy, new):
            got = obj.get(p)
            if isinstance(want, dict):
                assert got["k_alias_test"] == want["k_alias_test"], (p, got)
            else:
                assert got == want, (p, got)
    # Config(tree) resolves a dict as load_config resolves the file
    assert Config(user).as_dict() == t.as_dict()


def test_config_of_none_is_the_defaults_and_copies_deeply():
    import copy

    assert Config().as_dict() == defaults.default_config()
    assert Config().get("system.device") == "cuda"
    cfg = Config({"storage": {"result_root": "x"}})
    twin = copy.deepcopy(cfg)
    twin.set("storage.result_root", "y")
    assert cfg.get("storage.result_root") == "x" and twin.get("storage.result_root") == "y"
    assert as_config(cfg) is cfg and as_config(tconfig.config) is tconfig.config
    assert as_config({"a": 1}).get("a") == 1


def test_loader_reads_yaml_with_pyyaml_blocked(tmp_path):
    """As on the card's machine: no PyYAML (and no JAX); the singleton
    reads ANORAG_CONFIG, and serve.load_config the --config file."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.modules["yaml"] = None
        sys.modules["jax"] = None
        sys.modules["anorag_tpu"] = None
        from anorag_tpu_torch.config import ConfigLoader, config
        from anorag_tpu_torch.serve import load_config
        a = ConfigLoader({str(ROOT / "config.yaml")!r})
        b = load_config({str(ROOT / "config.yaml")!r})
        assert a.as_dict() == b.as_dict() == config.as_dict()
        print(json.dumps([a.as_dict(), a.report()]))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT), "ANORAG_CONFIG": str(ROOT / "config.yaml"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    tree, report = json.loads(out.stdout)
    j = JConfigLoader(str(ROOT / "config.yaml"))
    assert _as_reference(tree) == json.loads(json.dumps(j.as_dict()))
    assert report == j.report()


def test_embedding_manager_reads_backend_jax_as_the_torch_encoder():
    from anorag_tpu_torch.models.embedding_manager import EmbeddingManager

    cfg = ConfigLoader(str(ROOT / "config.yaml"))
    assert cfg.get("embedding.backend") == "jax"
    assert EmbeddingManager(cfg, device="cpu").backend == "torch"
    with pytest.raises(ValueError, match="unknown embedding backend"):
        EmbeddingManager({"embedding": {"backend": "onnx"}}, device="cpu")


# ------------------------------------------------------- the YAML reader
def _dumps():
    cfg = jdefaults.default_config()
    return [yaml.safe_dump(cfg), yaml.safe_dump(cfg, allow_unicode=True),
            yaml.safe_dump(cfg, default_flow_style=True),
            yaml.safe_dump(cfg, default_flow_style=None, width=30),
            yaml.safe_dump(cfg, default_flow_style=True, width=20, allow_unicode=True)]


HANDWRITTEN = [
    "a: 1e5\nb: 1.0e+5\nc: 0o7\nd: 010\ne: 0x1F\nf: 1_000\ng: 1:30\nh: .inf\n"
    "i: -.INF\nj: yes\nk: Off\nl: ~\nm:\nn: 'it''s'\no: \"\\u00e9\\x41\\t\"\n"
    "p: [a, {b: c, d}, []]\nq: {}\nr: 0b101\ns: +12.5\nt: 190:20:30.15\nu: .NaN2\n",
    "- - a\n  - b\n- c: 1\n  d:\n  - x\n  - y\n-\n  - z\n- 'q': \"w\"\n",
    "---\nkey: value # a comment\n# a line\n\n",
    "a: b\n  c d\n\n  e\nz: 'x\n\n  y'\nw: \"a\\\n   b\"\n",
    "a: {x: 1,\n  y: [1,\n   2]}\nb: \"q\"#c\nc: http://x:8/y\nd: a#b\n1: 2\ntrue: 3\n~: 4\n",
    "",
    "# only a comment\n",
    "plain top\n",
]


@pytest.mark.parametrize("text", [(ROOT / "config.yaml").read_text(), *_dumps(),
                                  *HANDWRITTEN],
                         ids=["config.yaml", "dump", "dump_unicode", "dump_flow",
                              "dump_mixed_narrow", "dump_flow_narrow",
                              *[f"handwritten{i}" for i in range(len(HANDWRITTEN))]])
def test_reader_equals_safe_load(text):
    assert safe_load(text) == yaml.safe_load(text)


BAD = {"anchor": "a: &x 1\nb: *x\n", "alias": "b: *x\n", "tag": "a: !!str 1\n",
       "literal block scalar": "a: |\n  x\n", "folded block scalar": "a: >\n  x\n",
       "second document": "a: 1\n---\nb: 2\n", "document end": "a: 1\n...\n",
       "timestamp": "a: 2001-01-01\n", "complex key": "? a\n: b\n",
       "merge key": "<<: {a: 1}\n", "mapping in a plain value": "a: b: c\n",
       "tab indent": "a:\n\t- x\n", "bad indent": "a:\n  b: 1\n c: 2\n",
       "unclosed quote": "a: 'x\n", "unclosed flow": "a: [1, 2\n",
       "pair in a flow sequence": "a: [b: c]\n", "directive": "%YAML 1.1\n---\na: 1\n",
       "content after a quote": "a: 'x' y\n"}


@pytest.mark.parametrize("name", sorted(BAD))
def test_reader_raises_outside_its_subset(name):
    with pytest.raises(ValueError, match=r"YAML line \d+"):
        safe_load(BAD[name])


_TEXT = string.ascii_letters + string.digits + " -_.:#,'\"[]{}!&*?|>%@`~\\/\n\té中"
_SCALARS = (st.none() | st.booleans() | st.integers(-10**12, 10**12)
            | st.floats(allow_nan=False) | st.text(_TEXT, max_size=90))
_KEYS = st.text(_TEXT.replace("\n", "").replace("\t", ""), min_size=1, max_size=24) \
    | st.integers(-99, 99)
_TREES = st.recursive(_SCALARS, lambda inner: st.lists(inner, max_size=4)
                      | st.dictionaries(_KEYS, inner, max_size=5), max_leaves=24)


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(tree=st.dictionaries(st.text(string.ascii_lowercase + "_", min_size=1, max_size=10),
                            _TREES, max_size=6),
       flow=st.sampled_from([False, None, True]), unicode=st.booleans(),
       width=st.sampled_from([20, 80]))
def test_reader_equals_safe_load_on_drawn_configs(tree, flow, unicode, width):
    text = yaml.safe_dump(tree, default_flow_style=flow, allow_unicode=unicode,
                          width=width, sort_keys=False)
    assert safe_load(text) == yaml.safe_load(text)


def test_reader_takes_a_stream(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text("a: {b: [1, 2.5, x]}\n")
    with open(path) as fh:
        assert safe_load(fh) == {"a": {"b": [1, 2.5, "x"]}}
