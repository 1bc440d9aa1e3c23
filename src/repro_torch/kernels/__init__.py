"""The port's hand-written Hopper kernels, described in one place.

Each entry of ``KERNELS`` names a CUDA source under ``csrc/``, the wrapper
that launches it on CUDA tensors (and runs the plain version on CPU
tensors), that plain PyTorch version in ``ref.py``, and the reference
package's TPU kernel it replaces (file:line of the function that reaches
``pl.pallas_call``).  Each wrapper counts its launches on its
``CudaKernel`` (``kernel.launches``), only where it launches.  A source
may hold several entries, counted by route: ``routed_neighbor_sample``'s
has the per-hop entry (the wrapper listed here, route ``hop``) and
``gather.routed_neighbor_sample_chain`` (route ``chain``), which the
device-sampling paths run; ``sage_aggregate``'s wrapper takes route
``vec`` or ``scalar`` by ``sage_agg.sage_route``.  The two routed
kernels take a clique's shards as separate tensors (a table of base
pointers, peer cards' included); their plain versions are the ``_peer``
forms, each bit for bit the reference's dense oracle over the stacked
shards.

One entry stands for a gradient, not a Pallas kernel: ``flash_attention_bwd``
(``csrc/flash_attention_bwd.cu``) is the backward of the LM path's
attention, which the reference gets by differentiating the ``lax.scan`` of
``models/layers.py:75`` (it has no backward Pallas kernel); its
``replaces`` names that function.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.kernels import (flash_attention, fused_batch, gather, ref,
                                 sage_agg, scatter)
from repro_torch.kernels._build import CudaKernel


@dataclasses.dataclass(frozen=True)
class PortedKernel:
    kernel: CudaKernel
    wrapper: Callable
    plain: Callable
    replaces: str  # the TPU kernel (or differentiated function), file:line

    @property
    def name(self) -> str:
        return self.kernel.name

    @property
    def source(self) -> str:
        """The CUDA source, relative to the repository root."""
        return str(self.kernel.source.relative_to(
            self.kernel.source.parents[4]))


KERNELS = (
    PortedKernel(fused_batch.KERNEL, fused_batch.fused_gather_overlay,
                 ref.fused_gather_overlay,
                 "src/repro/kernels/fused_batch.py:48"),
    PortedKernel(gather.KERNEL, gather.gather_rows, ref.gather_rows,
                 "src/repro/kernels/gather.py:37"),
    PortedKernel(scatter.KERNEL, scatter.scatter_rows, ref.scatter_rows,
                 "src/repro/kernels/scatter.py:36"),
    PortedKernel(gather.ROUTED_KERNEL, gather.routed_gather,
                 ref.routed_gather_peer, "src/repro/kernels/gather.py:80"),
    PortedKernel(gather.SAMPLE_KERNEL, gather.routed_neighbor_sample,
                 ref.routed_neighbor_sample_peer,
                 "src/repro/kernels/gather.py:119"),
    PortedKernel(flash_attention.KERNEL, flash_attention.flash_attention,
                 ref.flash_attention,
                 "src/repro/kernels/flash_attention.py:64"),
    PortedKernel(flash_attention.BWD_KERNEL,
                 flash_attention.flash_attention_bwd, ref.flash_attention_bwd,
                 "src/repro/models/layers.py:75"),
    PortedKernel(sage_agg.KERNEL, sage_agg.sage_aggregate, ref.sage_aggregate,
                 "src/repro/kernels/sage_agg.py:32"),
)

__all__ = ["KERNELS", "PortedKernel"]
