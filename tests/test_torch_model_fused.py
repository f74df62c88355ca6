"""The port's DeepLabV3+ against the JAX model with the fused kernel paths
(`fused_aspp`/`fused_decoder`) on both sides, and at 320 px OS16, whose
20x20 feature map is the first where every ASPP tap at rates (6, 12, 18)
lands (at 64 px and OS 8/16/32 the 8x8/4x4/2x2 maps leave only the centre
tap).

The JAX side runs its Pallas kernels in interpret mode, the port its
kernels' plain versions (CPU tensors). Weights, inputs and the tolerance
(rtol 1e-4 / atol 1e-4 on f32 logits ~1) are those of test_torch_model.py.
"""

import pytest

from test_torch_model import check_logits_match_jax_f32, one_torch_thread  # noqa: F401 (a fixture)


@pytest.mark.parametrize("model_type,output_stride,px,fused", [
    ("mobilenetv2", 8, 64, True),
    ("mobilenetv2", 16, 64, True),
    ("mobilenetv2", 32, 64, True),
    ("mobilenetv2", 16, 320, False),
    ("mobilenetv2", 16, 320, True),
    ("mobilenetv2_lite", 16, 320, False),
])
def test_logits_match_jax_f32(model_type, output_stride, px, fused):
    check_logits_match_jax_f32(model_type, output_stride, px, fused)
