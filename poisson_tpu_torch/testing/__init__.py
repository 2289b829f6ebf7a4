"""Test support: fault injection for the resilience and integrity layers
and the chaos campaign (counterpart of ``poisson_tpu/testing``)."""

from poisson_tpu_torch.testing.faults import (
    FaultPlan,
    PreemptionInjected,
    bitflip_element,
    bitflip_hook,
    chunk_hook,
    corrupt_file,
    inject_bitflip,
    inject_nan,
)

__all__ = [
    "FaultPlan",
    "PreemptionInjected",
    "bitflip_element",
    "bitflip_hook",
    "chunk_hook",
    "corrupt_file",
    "inject_bitflip",
    "inject_nan",
]
