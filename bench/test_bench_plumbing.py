"""The harness's plumbing for configurations of other families, on the
CPU: the existing cells' weights unmoved (digests of their tiny trees,
taken before the reference lookup and the weight rules were added),
the reference found by a configuration's ``"reference"`` key, weight
rules that a reference declares, and one whole run of a Mamba-2 +
attention hybrid (zamba2-1.2b's tiny configuration) through the serving
driver with a reference and weight rules that this file alone supplies.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
import types

import pytest
import torch

from bench import spec
from bench.testing import TINY_SECONDS, tiny_cell
from bench.test_bench_faults import FAULTS
from bench.weights import RULES, leaf_paths, make_params, rules_of

CPU = torch.device("cpu")


def _digest(tree) -> str:
    """sha256 of every leaf's path, dtype, shape and bytes, in order."""
    h = hashlib.sha256()
    for path, leaf in leaf_paths(tree):
        h.update(f"{path}:{leaf.dtype}:{tuple(leaf.shape)};".encode())
        flat = leaf.detach().contiguous().reshape(-1)
        h.update(flat.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:32]


# ---------------------------------------------------------------- existing cells

#: the tiny trees' digests before configurations named their references
#: (per cell: seed, dtype -> digest)
DIGESTS = {
    ("grok-1-314b.chat", 11, "float32"): "1d24bf861a95c50313406e0bbfbe09ae",
    ("grok-1-314b.chat", 11, "bfloat16"): "9cbccfe39122901355654278e748ca94",
    ("grok-1-314b.chat", 2**31 + 7, "float32"): "16f4777d428d684f61b4382fc4380166",
    ("grok-1-314b.chat", 2**31 + 7, "bfloat16"): "9c8c8edd6f9364a1d53c8e172d3beba2",
    ("qwen2-1.5b.docqa", 11, "float32"): "8adc8044c93cae17681e93a2f5955479",
    ("qwen2-1.5b.docqa", 11, "bfloat16"): "2eee27a9e24a4b3d497632749939b6b0",
    ("qwen2-1.5b.docqa", 2**31 + 7, "float32"): "f4803562e47ea1f1837f58e8501af41d",
    ("qwen2-1.5b.docqa", 2**31 + 7, "bfloat16"): "8806bc2f36b3a58cdf313e873e6edf61",
}


@pytest.mark.parametrize("cell,seed,dtype", sorted(DIGESTS))
def test_existing_cells_draw_the_same_weights(cell, seed, dtype):
    from repro_torch.config import ArchConfig
    from repro_torch.models.api import build_model

    _, _, config = tiny_cell(cell)
    model = build_model(ArchConfig(**config["config"]))
    rules = rules_of(spec.load_reference(config))
    params = make_params(model, seed, CPU, getattr(torch, dtype), rules)
    assert _digest(params) == DIGESTS[cell, seed, dtype]


def test_reference_is_decoder_without_the_key(monkeypatch):
    from bench.reference import decoder

    for name in ("grok-1-314b", "qwen2-1.5b"):
        config = json.loads((spec.BENCH / "configs" / f"{name}.json").read_text())
        assert "reference" not in config
        assert spec.load_reference(config) is decoder
    assert spec.load_reference({"reference": "decoder"}) is decoder
    named = types.ModuleType("bench.reference._named")
    monkeypatch.setitem(sys.modules, named.__name__, named)
    assert spec.load_reference({"reference": "_named"}) is named
    with pytest.raises(ModuleNotFoundError):
        spec.load_reference({"reference": "_no_such_reference"})


# ---------------------------------------------------------------- weight rules


class _Leaves:
    """A model stand-in: ``abstract_params`` gives ``shapes`` on meta."""

    def __init__(self, shapes: dict):
        self.shapes = shapes

    def abstract_params(self):
        tree: dict = {}
        for path, shape in self.shapes.items():
            *parents, last = path.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = torch.empty(shape, device="meta")
        return tree


SHAPES = {
    "embed/tok": (32, 8),
    "m/in_proj": (2, 8, 24),
    "m/conv_w": (2, 4, 16),
    "m/A_log": (2, 4),
    "m/ln/w": (2, 8),
    "final_norm/w": (8,),
}


def _ref(rules: dict):
    return types.SimpleNamespace(WEIGHT_RULES=rules)


def test_reference_rules_draw_their_leaves():
    """Each declared rule scales its leaf's slice of the same draw: a
    fan-in, a fixed std, an offset, and fp32 leaves (a norm's weight
    among them, drawn as the shared norms are)."""
    fp32 = ("A_log", "ln/w")
    unit = rules_of(_ref({"std": {"in_proj": 1.0, "conv_w": 1.0, "A_log": 1.0},
                          "fp32": fp32}))
    rules = rules_of(_ref({"fan_in": {"in_proj": (-2,)},
                           "std": {"conv_w": 0.5, "A_log": 0.25},
                           "offset": {"A_log": 1.0}, "fp32": fp32}))
    model = _Leaves(SHAPES)
    raw = make_params(model, 5, CPU, torch.bfloat16, unit)
    got = make_params(model, 5, CPU, torch.bfloat16, rules)
    m, r = got["m"], raw["m"]
    assert m["in_proj"].dtype == torch.bfloat16 and m["A_log"].dtype == torch.float32
    assert torch.equal(m["in_proj"], r["in_proj"] * (1 / 8**0.5))
    assert torch.equal(m["conv_w"], r["conv_w"] * 0.5)
    assert torch.equal(m["A_log"], r["A_log"] * 0.25 + 1.0)
    assert torch.equal(m["ln"]["w"], r["ln"]["w"])  # a norm: 1 + 0.1 N either way
    assert m["ln"]["w"].dtype == torch.float32
    assert (m["ln"]["w"] - 1).abs().max() < 1
    # the shared rules stay as they are, and a reference's take a name over
    assert rules["fan_in"]["tok"] == RULES["fan_in"]["tok"] == (-1,)
    over = rules_of(_ref({"std": {"wq": 0.02}}))
    assert over["std"]["wq"] == 0.02 and "wq" not in over["fan_in"]
    assert "wq" in RULES["fan_in"] and rules_of(None) == rules_of(_ref({}))


def test_leaf_without_a_rule_names_it():
    rules = rules_of(_ref({"std": {"conv_w": 1.0, "A_log": 1.0}, "fp32": ("ln/w",)}))
    with pytest.raises(KeyError, match="'m/in_proj'"):
        make_params(_Leaves(SHAPES), 5, CPU, torch.float32, rules)
    with pytest.raises(KeyError, match="fan_out"):
        rules_of(_ref({"fan_out": {}}))


# ---------------------------------------------------------------- another family

#: zamba2's leaves beyond the shared rules, as this test draws them:
#: matrices at their fan-in, the short conv at a fixed std, and A_log,
#: D, dt_bias and the gated norm's weight about their useful values
ZAMBA_RULES = {
    "fan_in": {k: (-2,) for k in ("in_proj", "out_proj", "q_a", "q_b", "m_a", "m_b")},
    "std": {"conv_w": 0.5, "conv_b": 0.1, "A_log": 0.5, "D": 0.1,
            "dt_bias": 0.5, "gn_w": 0.1},
    "offset": {"A_log": 1.0, "D": 1.0, "dt_bias": -3.0, "gn_w": 1.0},
    "fp32": ("ln/w", "A_log", "D", "dt_bias", "gn_w"),
}

#: the widest gap a sound run may read (fp32 on both sides)
ZAMBA_LIMIT = 1e-3


def _port_forward_logits(params, cfg, tokens, start, linear=None):
    """The port's own full-sequence forward in fp32 (``linear`` unused):
    a stand-in that checks the harness's plumbing, not a plain
    reference of the configuration."""
    from repro_torch.config import ArchConfig
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import unembed

    arch = ArchConfig(**dict(cfg, dtype="float32"))
    ids = torch.as_tensor(list(tokens), dtype=torch.long)[None]
    with torch.inference_mode():
        x = build_model(arch).forward(params, ids)[0]
        return unembed(params["embed"], x, arch)[0, start:].float()


def _zamba(monkeypatch) -> tuple:
    """(cell, configuration) of a zamba2-1.2b stand-in built here, its
    reference registered for this test alone."""
    from repro_torch.configs import get_tiny

    ref = types.ModuleType("bench.reference._zamba_plumbing")
    ref.logits, ref.WEIGHT_RULES = _port_forward_logits, ZAMBA_RULES
    monkeypatch.setitem(sys.modules, ref.__name__, ref)
    config = {"registry": "zamba2-1.2b", "reference": "_zamba_plumbing",
              "config": dataclasses.asdict(get_tiny("zamba2-1.2b"))}
    cell = {
        "name": "zamba2-1.2b.plumbing", "config": "zamba2-1.2b", "driver": "serve",
        "traffic": {"loop": "closed", "clients": 4, "ramp_s": 0.2, "strata": 4,
                    "prompt": {"dist": "uniform", "min": 4, "max": 16},
                    "new_tokens": 4},
        "engine": {"policy": "corec", "n_workers": 2, "claim_batch": 4,
                   "n_slots": 4, "max_seq": 32, "eos_token": -1},
        "warmup_prompts": [16, 4], "trace_s": 2.0, "drain_s": 60.0,
        "check": {"sample": 16, "limits": {"logit_gap": ZAMBA_LIMIT}},
    }
    return cell, config


@pytest.mark.parametrize("fault", [None] + sorted(FAULTS))
def test_hybrid_family_runs_through_unchanged_harness(fault, monkeypatch):
    """A Mamba-2 + attention hybrid goes through the serving driver as
    it stands: every leaf drawn by the test's rules, the engine serving
    through its slots, and ``correct`` true; false under each of
    ``test_bench_faults.py``'s faults.  Sound runs read a widest gap of
    0.0 on 12 seeds, the faults 4.3-6.3 on 3 seeds each."""
    from repro_torch.models.zamba import ZambaLM

    cell, config = _zamba(monkeypatch)
    if fault:
        monkeypatch.setattr(ZambaLM, "decode_step",
                            FAULTS[fault](ZambaLM.decode_step))
    driver = spec.load_driver(cell)
    rec = driver.run(cell, config, 2**31 + 21, TINY_SECONDS, False, device="cpu")
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert max(sum(active) for _, active in rec["steps"]) > 1  # slots shared a step
    assert rec["judged"]["tokens"] > 0
    assert rec["correct"] is (fault is None), rec["checks"]
