"""The port's ONNX export on the ResNet50, Xception, UNet x3 and Fast-SCNN
entries of the registry (tests/torch_onnx_checks.py), each its family's
representative, held against JAX's forward through both interpreters; and
the four groups of files together covering the registry once."""

import pytest

from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)
from torch_onnx_checks import GROUPS, check_representative

REPRESENTATIVES, OTHERS = GROUPS["rest"]


@pytest.mark.parametrize("model_type", REPRESENTATIVES)
def test_family_representative_matches_jax(model_type):
    check_representative(model_type)


def test_the_groups_cover_the_registry_once():
    from deeplabv3p_torch.models.factory import DEEPLAB_MODEL_REGISTRY
    from deeplabv3p_torch.models.fast_scnn import FAST_SCNN_MODEL_REGISTRY
    from deeplabv3p_torch.models.unet import UNET_MODEL_REGISTRY

    entries = [m for reps, others in GROUPS.values() for m in reps + others]
    assert len(entries) == 22
    assert sorted(entries) == sorted([*DEEPLAB_MODEL_REGISTRY, *UNET_MODEL_REGISTRY,
                                      *FAST_SCNN_MODEL_REGISTRY])
    assert sum(len(reps) for reps, _ in GROUPS.values()) == 11
