"""The port's analytic FLOP count (`lwsnet_tpu_torch.utils.flops`) against
the JAX package's (`lwsnet_tpu.utils.flops`): equal, integer for integer,
for every stage count and batch, at the KITTI eval window, the train crop
and the SceneFlow eval window, at the shipped widths and at other ones."""

import itertools

import pytest

from lwsnet_tpu import ModelConfig as JConfig
from lwsnet_tpu.utils import flops as jflops
from lwsnet_tpu_torch import ModelConfig
from lwsnet_tpu_torch.utils import flops

WIDTHS = {"shipped": {},
          "other": dict(feature_channels=16, channels_3d=4,
                        growth_rate=(2, 2, 1), refine_channels=16,
                        layers_3d=2, max_disp_list=(32, 3, 4))}


@pytest.mark.parametrize("hw", [(368, 1232), (256, 512), (544, 960)])
@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_forward_flops_match_jax(hw, width):
    cfg, jcfg = ModelConfig(**WIDTHS[width]), JConfig(**WIDTHS[width])
    for stages, batch in itertools.product((1, 2, 3, 4), (1, 4)):
        args = (*hw, batch, stages)
        assert flops.forward_macs(cfg, *args) == \
            jflops.forward_macs(jcfg, *args), (stages, batch)
        assert flops.forward_flops(cfg, *args) == \
            jflops.forward_flops(jcfg, *args), (stages, batch)
        assert flops.forward_flops(cfg, *args) == \
            2 * flops.forward_macs(cfg, *args)


def test_shipped_forward_flops():
    """The 368x1232 batch-1 figures PERF.md quotes."""
    got = [flops.forward_flops(ModelConfig(), 368, 1232, 1, k)
           for k in (1, 2, 3, 4)]
    assert got == [39873512448, 43619304960, 58602475008, 90897354240]
