"""Abstract state: the port's ``meta``-device stand-ins against the
reference's ``ShapeDtypeStruct``s, leaf for leaf (path, shape, dtype).

For all ten full configs: ``model.abstract_params()`` (and
``models.spec.abstract_params`` of the specs), the step bundle's
``abstract_state()`` (parameters + AdamW moments and step count), and
``launch.specs.input_specs`` for every applicable (arch x shape) cell
(``config.py``'s ``SHAPES`` and ``cell_is_applicable``): the train and
prefill batches, and the decode cells' cache and token stand-ins.  Every
port leaf lies on the ``meta`` device: nothing is allocated, even for
grok-1's 314 B parameters.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.config import SHAPES as JSHAPES  # noqa: E402
from repro.launch.specs import input_specs as jinput_specs  # noqa: E402
from repro.launch.steps import build_steps as jbuild_steps  # noqa: E402
from repro.models.api import build_model as jbuild_model  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.config import SHAPES, cell_is_applicable  # noqa: E402
from repro_torch.launch.specs import input_specs  # noqa: E402
from repro_torch.launch.steps import build_steps  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.models.spec import abstract_params  # noqa: E402
from repro_torch.tree import tree_paths  # noqa: E402

CELLS = [
    (arch, shape.name)
    for arch in configs.ALL_ARCHS
    for shape in SHAPES
    if cell_is_applicable(configs.get(arch), shape)[0]
]


def _jleaves(tree) -> list:
    return [
        ("/".join(str(k) for k in p), tuple(x.shape), np.dtype(x.dtype).name)
        for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]
    ]


def _leaves(tree) -> list:
    out = []
    for p, x in tree_paths(tree):
        assert isinstance(x, torch.Tensor) and x.device.type == "meta", p
        out.append((p, tuple(x.shape), str(x.dtype).removeprefix("torch.")))
    return out


def test_every_applicable_cell_is_listed():
    assert len(CELLS) == 32
    assert [s.name for s in SHAPES] == [s.name for s in JSHAPES]


@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_abstract_params_equal_reference(arch):
    jmodel, model = jbuild_model(jconfigs.get(arch)), build_model(configs.get(arch))
    want = _jleaves(jmodel.abstract_params())
    assert _leaves(model.abstract_params()) == want
    assert _leaves(abstract_params(model.param_specs())) == want
    assert sum(int(np.prod(s)) for _, s, _ in want) > 0


@pytest.mark.parametrize("arch", configs.ALL_ARCHS)
def test_abstract_state_equals_reference(arch):
    mesh = ((16, 16), ("data", "model"))
    want = _jleaves(jbuild_steps(jconfigs.get(arch), JAbstractMesh(*mesh)).abstract_state())
    got = build_steps(configs.get(arch), device="cpu").abstract_state()
    assert _leaves(got) == want


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_reference(arch, shape):
    jshape = next(s for s in JSHAPES if s.name == shape)
    tshape = next(s for s in SHAPES if s.name == shape)
    want = _jleaves(jinput_specs(jconfigs.get(arch), jshape))
    assert _leaves(input_specs(configs.get(arch), tshape)) == want
