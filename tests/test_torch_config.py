"""The port's config loading against PyYAML and the JAX package's loaders.

The port reads and writes YAML itself (street_gaussians_torch/utils/
yaml_subset.py: the subset every file under configs/ uses). Here every
config file reads as yaml.safe_load reads it, the loaders
(load_yaml_with_parents, load_config with CLI overrides, derive_paths)
give what street_gaussians_tpu/config.py gives, save_config's output
reads back equal through both readers, and input outside the subset
raises naming its line. Values compare equal with their types (1 and
1.0 differ, True and 1 differ); no tolerance.
"""

import glob
import math
import os

import pytest
import yaml

from street_gaussians_torch import config as tconfig
from street_gaussians_torch.utils import yaml_subset
from street_gaussians_tpu import config as jconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_FILES = sorted(os.path.relpath(p, REPO) for p in glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"),
                                                                   recursive=True))


def assert_typed_equal(got, want, where=""):
    """Equal values of equal types, recursively (NaN equals NaN)."""
    assert type(got) is type(want), f"{where}: {got!r} ({type(got).__name__}) vs {want!r} ({type(want).__name__})"
    if isinstance(want, dict):
        assert set(got) == set(want), f"{where}: keys {set(got) ^ set(want)}"
        for k in want:
            assert_typed_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_typed_equal(a, b, f"{where}[{i}]")
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), where
    else:
        assert got == want, f"{where}: {got!r} vs {want!r}"


def test_every_config_is_a_file_of_the_subset():
    assert len(CONFIG_FILES) >= 13


@pytest.mark.parametrize("path", CONFIG_FILES)
def test_reader_equals_pyyaml_on_every_config(path):
    full = os.path.join(REPO, path)
    with open(full) as f:
        want = yaml.safe_load(f)
    assert_typed_equal(yaml_subset.load_file(full), want, path)


# plain scalars PyYAML 6's safe_load resolves (YAML 1.1): floats need a
# dot and a signed exponent, bools come in three casings, ~ / null / ''
# are None, underscores and sexagesimal ints and floats, octal, hex
SCALARS = [
    "1e-5", "1.0e-5", "5.0e-5", "1.6e-06", "3.", "1.", ".5", "-4", "+4", "1_000", "0", "017", "0x1F", "0b101",
    "1:30", "1:30.5", "1.0e+20", "1e+5", ".inf", "-.inf", ".NaN", "yes", "Yes", "YES", "no", "on", "Off", "true",
    "False", "tRue", "y", "~", "null", "Null", "", "/tmp/x", "./data/waymo/training/002", "127.0.0.1", "a b",
    "'quoted # not a comment'", '"double"', "value # comment", "[0, 1, 2]", "[]", "[1, 1, 0]",
    "[a, 'b c', 1.5, true, ~]", "{}", "logits",
]


@pytest.mark.parametrize("text", SCALARS)
def test_scalar_resolution_equals_pyyaml(text):
    assert_typed_equal(yaml_subset.loads(text), yaml.safe_load(text), repr(text))


@pytest.mark.parametrize("path", ["configs/example/waymo_train_002.yaml",
                                  "configs/experiments_waymo/waymo_val_006.yaml"])
def test_load_yaml_with_parents_equals_jax(path):
    full = os.path.join(REPO, path)
    assert_typed_equal(tconfig.load_yaml_with_parents(full).to_dict(),
                       jconfig.load_yaml_with_parents(full).to_dict(), path)


def test_parent_found_through_workspace(tmp_path, monkeypatch):
    """A parent that is not beside the (relative) file is looked up under
    `workspace`, as the JAX loader looks it up."""
    (tmp_path / "ws").mkdir()
    (tmp_path / "ws" / "base.yaml").write_text("a: 1\nb: {}\n")
    (tmp_path / "child.yaml").write_text(f"parent_cfg: base.yaml\nworkspace: {tmp_path / 'ws'}\nb:\n  c: 2\n")
    monkeypatch.chdir(tmp_path)
    got = tconfig.load_yaml_with_parents("child.yaml").to_dict()
    assert_typed_equal(got, jconfig.load_yaml_with_parents("child.yaml").to_dict())
    assert got["b"] == {"c": 2}


OVERRIDES = [
    ("optim.position_lr_init", "1e-5"),  # a string, as PyYAML reads it
    ("optim.position_lr_init", "1.0e-5"),
    ("optim.lambda_l1", "3."),
    ("data.white_background", "yes"),
    ("data.extent", "~"),
    ("data.cameras", "[1, 2]"),
    ("train.iterations", "-4"),
    ("render.instance_capacity", "1_000"),
    ("source_path", "/data/waymo/training/002"),
    ("new.nested.key", "value # with a comment"),
]


@pytest.mark.parametrize("key,value", OVERRIDES)
def test_load_config_with_overrides_equals_jax(key, value):
    path = os.path.join(REPO, "configs/example/waymo_train_002.yaml")
    opts = ["model_path", "/out/run", key, value]
    got = tconfig.load_config(path, opts, mode="evaluate")
    want = jconfig.load_config(path, opts, mode="evaluate")
    assert_typed_equal(got.to_dict(), want.to_dict(), f"{key} {value}")
    node = got
    for p in key.split("."):
        node = node[p]
    assert_typed_equal(node, yaml.safe_load(value), key)


@pytest.mark.parametrize("preset", [{}, {"model_path": "/m", "record_dir": "/r"}, {"task": "t", "exp_name": "e"}])
def test_derive_paths_equals_jax(preset):
    got = tconfig.derive_paths(tconfig.Config.from_dict({**tconfig.default_config().to_dict(), **preset}))
    want = jconfig.derive_paths(jconfig.Config.from_dict({**jconfig.default_config().to_dict(), **preset}))
    assert_typed_equal(got.to_dict(), want.to_dict())


def test_argparser_and_config_from_args_equal_jax():
    argv = ["--config", os.path.join(REPO, "configs/demo_synthetic.yaml"), "--mode", "evaluate",
            "train.iterations", "7", "data.cameras", "[0, 1]"]
    got = tconfig.config_from_args(tconfig.make_argparser("t").parse_args(argv))
    want = jconfig.config_from_args(jconfig.make_argparser("j").parse_args(argv))
    assert_typed_equal(got.to_dict(), want.to_dict())


def test_merge_and_to_dict():
    cfg = tconfig.Config.from_dict({"a": {"b": 1, "c": [1]}, "d": 2})
    cfg.merge({"a": {"b": 3, "e": {"f": None}}, "g": "h"})
    assert cfg.to_dict() == {"a": {"b": 3, "c": [1], "e": {"f": None}}, "d": 2, "g": "h"}
    assert isinstance(cfg.a.e, tconfig.Config)


@pytest.mark.parametrize("source", ["default", "waymo_train_002", "edge strings"])
def test_save_config_reads_back_through_both_readers(tmp_path, source):
    if source == "default":
        cfg = tconfig.load_config()
    elif source == "waymo_train_002":
        cfg = tconfig.load_config(os.path.join(REPO, "configs/example/waymo_train_002.yaml"),
                                  ["optim.position_lr_init", "1e-5", "optim.lambda_l1", "3."])
    else:
        cfg = tconfig.default_config()
        cfg.merge({"s": {"empty": "", "yes": "yes", "num": "1.5", "null": "null", "colon": "a: b",
                         "hash": "a #b", "dash": "- x", "quote": "it's", "brackets": "[x]", "lead": " x",
                         "list": ["a, b", "1", "", "c"], "inf": math.inf, "nan": math.nan, "tiny": 1e-20,
                         "big": 1e20, "neg": -0.5, "int": 12, "ts": "2001-12-14", "tilde": "~"}})
    path = str(tmp_path / "configs" / "config_train.yaml")
    tconfig.save_config(cfg, path)
    with open(path) as f:
        text = f.read()
    assert_typed_equal(yaml.safe_load(text), cfg.to_dict(), "yaml.safe_load")
    assert_typed_equal(yaml_subset.loads(text), cfg.to_dict(), "yaml_subset")


OUTSIDE = {
    "anchor": "a: &x 1\nb: 2\n",
    "alias": "a: 1\nb: *x\n",
    "tag": "a: !!str 1\n",
    "literal block scalar": "a: |\n  text\n",
    "folded block scalar": "a: >\n  text\n",
    "tab": "a:\n\tb: 1\n",
    "flow mapping": "a: {b: 1}\n",
    "block sequence": "a:\n  - 1\n  - 2\n",
    "escaped double quotes": 'a: "x\\ny"\n',
    "escaped single quote": "a: 'it''s'\n",
    "nested flow sequence": "a: [[1, 2], 3]\n",
    "multi-line plain scalar": "a: one\n  two\n",
    "document marker": "---\na: 1\n",
    "timestamp": "a: 2001-12-14\n",
}


@pytest.mark.parametrize("case", sorted(OUTSIDE))
def test_reader_raises_outside_the_subset(case):
    text = OUTSIDE[case]
    line = next(i for i, ln in enumerate(text.splitlines(), 1)
                if any(c in ln for c in "&*!|>\t{'\"") or ln.startswith(("  -", "  two", "---", "a: 2001", "a: [[")))
    with pytest.raises(yaml_subset.YAMLSubsetError, match=f"cfg.yaml:{line}:"):
        yaml_subset.loads(text, where="cfg.yaml")

