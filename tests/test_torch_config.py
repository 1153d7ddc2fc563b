"""The port's config reader and writer (gtcrn_micro_tpu_torch.utils.config)
held against PyYAML's ``safe_load`` (YAML 1.1, what the consumers were
written against), and the port's ``StftConfig`` against JAX's.

The reader must give ``yaml.safe_load``'s values type for type, before the
``${a.b}`` interpolation both sides then share: ``1e-3`` is the string
``'1e-3'`` (no dot), ``1.0e-3`` a float, ``false``/``off`` bools, ``~``
and empty values None.  With PyYAML blocked (``sys.modules["yaml"] =
None``) the repo's configs still load.  The writer's text reads back equal
through both readers.
"""

import glob
import math
import os
import sys

import pytest
import yaml

from gtcrn_micro_tpu.dsp.stft import StftConfig as JStftConfig
from gtcrn_micro_tpu_torch.dsp.stft import StftConfig
from gtcrn_micro_tpu_torch.utils import config as cfgmod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def _same(a, b):
    """Equal values of equal types, recursively (NaN equals NaN)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _pyyaml_config(text):
    cfg = cfgmod._wrap(yaml.safe_load(text) or {})
    cfgmod._resolve(cfg, cfg)
    return cfg.to_dict()


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_configs_load_as_pyyaml_loads_them(path):
    text = open(path).read()
    assert _same(cfgmod.parse_yaml(text), yaml.safe_load(text))
    assert _same(cfgmod.load_config(path).to_dict(), _pyyaml_config(text))


def test_dns3_types_are_pyyamls():
    cfg = cfgmod.load_config(os.path.join(ROOT, "configs", "cfg_train_dns3.yaml"))
    assert cfg.scheduler.kwargs.max_lr == "1e-3" and cfg.loss.eps == "1e-12"
    assert cfg.train_dataset.random_start is False and cfg.loss.n_fft == 512
    assert len(CONFIGS) == 4


EDGE_CASES = {
    "exponents": "a: 1e-3\nb: 1.0e-3\nc: 1.5e+3\nd: 1e3\ne: .5\nf: 6.\ng: -1.5E-2\n",
    "bools": "a: false\nb: True\nc: yes\nd: Off\ne: on\nf: NO\n",
    "nulls": "a: ~\nb: null\nc:\nd: NULL  # comment\n",
    "ints": "a: 017\nb: 0x1F\nc: 1_000\nd: -0\ne: +12\nf: 0b101\ng: 1:30\nh: 0o17\n",
    "floats": "a: 190:20:30.15\nb: -.inf\nc: .NaN\nd: .Inf\n",
    "quoted": "a: 'quoted # not a comment'\nb: \"dq \\t \\\" x\"\nc: 'it''s'\nd: '1e-3'\n"
              "e: \"yes\"\n'f g': 1\n\"h\": 2\n",
    "comments": "# top\na: 1   # inline\nb: x#y\nc: http://x.y/z#frag\n\n  # indented\nd: 2\n",
    "empty_values": "a:\nb: []\nc: {}\nd: ''\ne:\n  f:\n",
    "nested": "a:\n  b:\n    c: 1\n  d: ${a.b.c}\ne: ${a.d}/x\n",
    "lists": "a:\n- 1\n- b: 2\n  c: []\n- - x\n  - y\nd:\n  - 3\n  -\n    k: v\ne: [] \n",
    "keys": "1: a\ntrue: b\n'1': c\nnull: d\n",
}


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_edge_cases_match_pyyaml(name):
    text = EDGE_CASES[name]
    assert _same(cfgmod.parse_yaml(text), yaml.safe_load(text)), name
    assert _same(cfgmod.loads_config(text).to_dict(), _pyyaml_config(text))


@pytest.mark.parametrize("text", ["a: &x 1\n", "a: !!str 1\n", "a: |\n  b\n", "a: [1, 2]\n",
                                  "a: 2024-01-01\n", "---\na: 1\n", "a: 'open\n"])
def test_outside_the_subset_raises(text):
    with pytest.raises(ValueError):
        cfgmod.parse_yaml(text)


def test_configs_load_without_pyyaml(monkeypatch):
    want = [cfgmod.load_config(p).to_dict() for p in CONFIGS]
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises ImportError
    with pytest.raises(ImportError):
        import yaml as _  # noqa: F401
    assert [cfgmod.load_config(p).to_dict() for p in CONFIGS] == want


DUMPED = {
    "scalars": {"s": ["1e-3", "", " x", "a: b", "- q", "it's", "#c", "yes", "~", "[a]",
                      "x #y", "${a.b}", "tab\there", 'q"\\', "é ü"],
                "f": [1e-5, 0.1, 3.0, float("inf"), -float("inf"), float("nan"), 1e20],
                "i": [0, -7, 2**40], "b": [True, False], "n": None},
    "nested": {"a": {"b": {"c": [1, {"d": [], "e": {}}, [2, 3]]}}, "k": {"yes": 1, "": 2}},
}


@pytest.mark.parametrize("name", sorted(DUMPED))
def test_writer_reads_back_equal(name, tmp_path):
    data = DUMPED[name]
    text = cfgmod.dump_yaml(data)
    assert _same(cfgmod.parse_yaml(text), data)
    assert _same(yaml.safe_load(text), data)
    cfgmod.save_config(data, str(tmp_path / "c.yaml"))
    assert _same(cfgmod.parse_yaml((tmp_path / "c.yaml").read_text()), data)


def test_stft_config_is_jaxs():
    for args in ((), (320, 160, 320, 8000)):
        t, j = StftConfig(*args), JStftConfig(*args)
        assert (t.n_fft, t.hop_len, t.win_len, t.fs, t.n_freqs) == (
            j.n_fft, j.hop_len, j.win_len, j.fs, j.n_freqs)
        assert [t.num_frames(n) for n in (0, 255, 256, 16000)] == [
            j.num_frames(n) for n in (0, 255, 256, 16000)]
