"""The port's copies of the config dataclass and registry equal the
reference's."""

import dataclasses

import pytest

from repro import configs as jcfg
from repro_torch import configs as tcfg


def test_registry_lists_the_same_archs():
    assert tcfg.list_archs() == jcfg.list_archs()


@pytest.mark.parametrize("arch", jcfg.list_archs())
def test_full_and_smoke_configs_equal(arch):
    for getter in ("get_config", "smoke_config"):
        ref = getattr(jcfg, getter)(arch)
        port = getattr(tcfg, getter)(arch)
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.resolved_head_dim == ref.resolved_head_dim
