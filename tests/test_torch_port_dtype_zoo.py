"""bf16 victims of the rest of the zoo against the JAX package's, by the gap
rule of ``test_torch_port_dtype`` (the port's bf16 logits and input
gradient no further from the JAX bf16 ones than those are from the JAX
fp32 ones, argmax equal, bf16 logits): Inception-v3 at its smallest input,
MobileNetV2, VGG-11 with a narrow classifier and ViT-tiny. Split from that
file so that the two spread over test workers.

What each family exercises: Inception-v3's padded 3x3 average pools, which
sum their taps in bf16 one at a time as XLA does; MobileNetV2's ReLU6 (the
cap at 6 in bf16); VGG's bias-carrying convolutions and dense classifier;
ViT's bf16 attention (its softmax op by op, with JAX's backward), its
LayerNorms (fp32 statistics, one rounding) and its exact GELU written as
``jax.nn.gelu`` writes it.
"""

import pytest

from test_torch_port_dtype import N, _port16, assert_gap_rule, bf16_ratios, jax_pair
from test_torch_port_zoo import _images


@pytest.mark.parametrize("name,size,kwargs", [
    ("inception_v3", 75, {}),
    ("mobilenet_v2", 32, {}),
    ("vgg11", 32, {"hidden": 64}),
    ("vit_tiny", 32, {}),
])
def test_bf16_victim_matches_jax_within_its_gap(name, size, kwargs):
    jax32, jax16, variables = jax_pair(name, size, **kwargs)
    r = bf16_ratios(jax32, jax16, _port16(name, size, variables, **kwargs), _images(size, n=N))
    assert_gap_rule(r, name)
