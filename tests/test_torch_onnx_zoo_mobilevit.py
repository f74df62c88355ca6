"""The port's ONNX export on the MobileViT entries of the registry
(tests/torch_onnx_checks.py): each family's representative held against
JAX's forward through both interpreters, the other entries converted and
run against the eager model."""

import pytest

from test_torch_model import one_torch_thread  # noqa: F401 (a fixture)
from torch_onnx_checks import GROUPS, check_converts, check_representative

REPRESENTATIVES, OTHERS = GROUPS["mobilevit"]


@pytest.mark.parametrize("model_type", REPRESENTATIVES)
def test_family_representative_matches_jax(model_type):
    check_representative(model_type)


@pytest.mark.parametrize("model_type", OTHERS)
def test_registry_entry_converts(model_type):
    check_converts(model_type)
