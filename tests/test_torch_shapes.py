"""``configs.shapes`` against the reference's: for all 40 (arch x shape)
cells, ``cell_config``'s config and note are equal, and every leaf of
``input_specs`` (meta tensors in the port, ``ShapeDtypeStruct`` s in the
reference) has the reference's shape and dtype. The serve cache's "idx"
and "pos" are host ints in the port (one "idx" a segment) and int32
arrays in the reference ("idx" one entry a layer, all equal).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs import shapes as jshapes
from repro_torch.configs import registry
from repro_torch.configs import shapes

# one intra-op thread: the suite's pytest-xdist workers share the
# cores, and oversubscribed OpenMP pools spin against each other
torch.set_num_threads(1)

CELLS = [(a, s) for a in jregistry.ARCHS for s in jshapes.SHAPES]


def _flat(tree, prefix=""):
    """{path: (shape, dtype name)} of a port spec tree."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta", prefix
        return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    assert isinstance(tree, int), (prefix, tree)
    return {prefix: "host int"}


def _jflat(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "".join(f"/{getattr(p, 'key', getattr(p, 'idx', p))}"
                      for p in path)
        out[key] = (tuple(leaf.shape), np.dtype(leaf.dtype).name)
        if key.endswith(("/idx", "/pos")):
            assert out[key][1] == "int32", key
            out[key] = "host int"
    return out


def test_shapes_table_equal():
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    assert registry.ARCHS == jregistry.ARCHS


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_config_and_input_specs_match_reference(arch, shape):
    cfg, note = shapes.cell_config(arch, shape)
    jcfg, jnote = jshapes.cell_config(arch, shape)
    assert note == jnote
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got = _flat(shapes.input_specs(cfg, shape))
    want = _jflat(jshapes.input_specs(jcfg, shape))
    assert got == want


def test_reduced_cell_config_and_overrides():
    cfg, note = shapes.cell_config("qwen3-4b", "long_500k", True,
                                   remat="full")
    jcfg, jnote = jshapes.cell_config("qwen3-4b", "long_500k", True,
                                      remat="full")
    assert note == jnote and cfg.attn_impl == "srf"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    got = _flat(shapes.input_specs(cfg, "train_4k", 4, 32))
    assert got == _jflat(jshapes.input_specs(jcfg, "train_4k", 4, 32))
