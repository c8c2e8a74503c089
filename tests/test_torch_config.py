"""The port's config copy (``repro_torch.config``) against
``repro.config.base``: every field it keeps has the reference's name and
default, and ``mnist_cnn`` sets them to the reference's values."""
import dataclasses

import pytest

import repro.config.base as jbase
from repro.configs import get_config as jget_config
from repro_torch.config import base as tbase
from repro_torch.configs import get_config

SECTIONS = ["model", "quant", "channel", "energy", "convergence", "fl",
            "fleet", "power", "train"]


@pytest.mark.parametrize("section", SECTIONS)
def test_fields_are_the_references(section):
    tcls = type(getattr(tbase.Config(), section))
    jcls = type(getattr(jbase.Config(), section))
    assert tcls.__name__ == jcls.__name__
    jdefaults = {f.name: f.default for f in dataclasses.fields(jcls)}
    for f in dataclasses.fields(tcls):
        assert f.name in jdefaults, f"{section}.{f.name} is not a reference field"
        assert f.default == jdefaults[f.name], f"{section}.{f.name} default differs"


@pytest.mark.parametrize("section", SECTIONS)
def test_mnist_cnn_matches_the_reference(section):
    tsec = getattr(get_config("mnist_cnn"), section)
    jsec = getattr(jget_config("mnist_cnn"), section)
    for f in dataclasses.fields(tsec):
        got, want = getattr(tsec, f.name), getattr(jsec, f.name)
        if dataclasses.is_dataclass(got):   # the port's own sub-config class
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f"{section}.{f.name}"


def test_wire_fields_are_ported_and_use_pallas_is_not():
    """The cohort round reads ``wire_format``, ``pipeline_hops`` and
    ``cohort_axes`` with the reference's defaults.  ``use_pallas`` is not
    ported: on a CUDA tensor the port always runs its kernel, on a CPU
    tensor the kernel's plain version."""
    tq = {f.name for f in dataclasses.fields(tbase.QuantConfig)}
    jq = {f.name for f in dataclasses.fields(jbase.QuantConfig)}
    assert {"wire_format", "pipeline_hops"} <= tq
    assert "use_pallas" in jq and "use_pallas" not in tq
    assert tbase.FLConfig().cohort_axes == jbase.FLConfig().cohort_axes
    assert tbase.COLLECTIVE_CHOICES == jbase.COLLECTIVE_CHOICES


def test_policy_registries_are_the_references():
    assert tbase.SELECTION_POLICIES == jbase.SELECTION_POLICIES
    assert tbase.POWER_POLICIES == jbase.POWER_POLICIES
    assert tbase.FleetConfig(size=3).enabled and not tbase.FleetConfig().enabled
