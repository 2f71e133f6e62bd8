"""Pin the port's roofline constants to the reference's for parity tests.

The port prices plans with the H100's constants
(``repro_torch/launch/roofline.py``), the reference with its own
(``repro/launch/roofline.py``).  A parity test that feeds the same
vectors through both packages first rebinds every constant the port's
modules read, so both sides price a plan the same way.  The port's
modules bind the constants at import, as the reference does, and read
those module bindings when a call runs: no default argument and no
class attribute holds a copy (a planner's ``microbatch_overhead_s`` and
``pcie_gbps`` are ``None`` unless given).  So rebinding every module
attribute of that name is enough, and the pin checks that no class
attribute holds a copy.
"""
import importlib
import inspect
import pkgutil

import repro_torch
from repro.launch import roofline as ref_roofline

# the reference's one PEAK_FLOPS is its chip's bf16 rate; the port keeps
# an fp32 and a bf16 rate, and both take it
REF = {"PEAK_FLOPS": ref_roofline.PEAK_FLOPS,
       "PEAK_FLOPS_BF16": ref_roofline.PEAK_FLOPS,
       "PCIE_BW": ref_roofline.PCIE_BW,
       "MICROBATCH_OVERHEAD_S": ref_roofline.MICROBATCH_OVERHEAD_S}


def port_modules() -> list:
    """Every module of the port, imported."""
    return [importlib.import_module(m.name) for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]


def pin_reference_constants(monkeypatch) -> dict:
    """Rebind the constants in every port module that binds them;
    raise if a class of the port holds one of their values.  Returns
    the pinned values."""
    from repro_torch.launch import roofline
    port = {name: getattr(roofline, name) for name in REF}
    for mod in port_modules():
        for name, value in REF.items():
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, value)
        for _, cls in inspect.getmembers(mod, inspect.isclass):
            if not cls.__module__.startswith("repro_torch."):
                continue
            for attr, v in vars(cls).items():
                for name, value in port.items():
                    if isinstance(v, float) and v in (value, value / 1e9):
                        raise AssertionError(
                            f"{cls.__module__}.{cls.__name__}.{attr} holds "
                            f"a copy of {name}; read it when a call runs")
    return dict(REF)
