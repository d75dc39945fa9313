"""The port's decoder-LM configs against the JAX package's: every arch's
CONFIG and REDUCED, the input shapes, the registry and ``reduced``'s
overrides equal field for field (``dataclasses.asdict``)."""
import dataclasses

import pytest

from repro import configs as jcfg
from repro_torch import configs as tcfg

ARCHS = jcfg.list_archs()


def test_registry_lists_the_same_archs_in_the_same_order():
    assert tcfg.list_archs() == ARCHS
    assert tcfg.ARCH_MODULES == jcfg.ARCH_MODULES


@pytest.mark.parametrize("variant", ["CONFIG", "REDUCED"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_the_reference(arch, variant):
    red = variant == "REDUCED"
    got = tcfg.get_config(arch, reduced_variant=red)
    want = jcfg.get_config(arch, reduced_variant=red)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.resolved_head_dim == want.resolved_head_dim
    assert got.resolved_stages == want.resolved_stages


def test_input_shapes_equal_the_reference():
    assert ({k: dataclasses.asdict(v) for k, v in tcfg.INPUT_SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in jcfg.INPUT_SHAPES.items()})


@pytest.mark.parametrize("overrides", [
    {}, {"n_layers": 4}, {"sliding_window": 8, "kv_cache_int8": True},
    {"attn_q_block": 0, "attn_kv_block": 64}])
@pytest.mark.parametrize("arch", ["musicgen-medium", "gemma3-27b",
                                  "deepseek-v2-236b", "hymba-1.5b"])
def test_reduced_with_overrides_equals_the_reference(arch, overrides):
    got = tcfg.reduced(tcfg.get_config(arch), **overrides)
    want = jcfg.reduced(jcfg.get_config(arch), **overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
