"""Operation-asymmetry cost model for an H100 cluster (paper §2 → GPUs).

Port of ``repro/core/asymmetry.py``.  The paper's local/remote asymmetry
maps onto a GPU cluster's two fabrics: NVLink inside a node (the "local"
class) and one InfiniBand port per GPU between nodes (the "remote" class),
an order of magnitude slower per GPU, the local:RDMA cost ratio the paper
cites.  The wire-byte formulas are the reference's, unchanged: the standard
bandwidth-optimal algorithm factors

* all-reduce over an axis of size ``a``: ``2 (a-1)/a × bytes`` on the wire
* reduce-scatter / all-gather:           ``(a-1)/a × bytes``
* all-to-all:                             ``(a-1)/a × bytes`` (each GPU keeps 1/a)

``core/cohort.py`` counts the bytes each of its collectives puts on a group
with these formulas.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class H100:
    """Per-GPU constants of an NVIDIA H100 SXM5 (NVIDIA H100 Tensor Core GPU
    data sheet; dense rates, no sparsity)."""

    peak_flops_bf16: float = 989e12     # FLOP/s, bf16 tensor cores, dense
    hbm_bw: float = 3.35e12             # B/s, HBM3
    nvlink_bw: float = 450e9            # B/s each way (NVLink 4: 900 GB/s total per GPU)
    ib_bw_per_gpu: float = 50e9         # B/s each way: one 400 Gb/s NDR InfiniBand port per GPU
    hbm_bytes: float = 80e9             # HBM3 capacity

    # ------------------------------------------------------------- rooflines
    def compute_time(self, flops: float, gpus: int = 1) -> float:
        return flops / (gpus * self.peak_flops_bf16)

    def memory_time(self, bytes_: float, gpus: int = 1) -> float:
        return bytes_ / (gpus * self.hbm_bw)

    def collective_time(self, wire_bytes_per_gpu: float, *, inter_node: bool = False) -> float:
        """Time for ``wire_bytes_per_gpu`` already adjusted by algo factors."""
        return wire_bytes_per_gpu / (self.ib_bw_per_gpu if inter_node else self.nvlink_bw)


def allreduce_wire_bytes(payload_bytes: float, axis: int) -> float:
    """Per-GPU wire bytes for a bandwidth-optimal all-reduce (RS+AG)."""
    return 2.0 * (axis - 1) / axis * payload_bytes


def reduce_scatter_wire_bytes(payload_bytes: float, axis: int) -> float:
    return (axis - 1) / axis * payload_bytes


def all_gather_wire_bytes(payload_bytes: float, axis: int) -> float:
    """payload_bytes = the *gathered* (full) size; each GPU holds 1/axis."""
    return (axis - 1) / axis * payload_bytes


def all_to_all_wire_bytes(payload_bytes: float, axis: int) -> float:
    return (axis - 1) / axis * payload_bytes


def cohort_vs_flat_dcn_bytes(
    grad_bytes: float, pods: int, chips_per_pod: int
) -> dict:
    """Napkin math for the paper's headline effect.

    Flat all-reduce over ``pods × chips_per_pod`` GPUs treats both fabrics
    alike: every GPU's full gradient joins a ring that spans the slow one,
    so it carries ``2 (n-1)/n × grad_bytes`` per GPU.

    The cohort schedule: a reduce-scatter inside each pod elects each GPU
    "leader" of a ``1/chips_per_pod`` fragment; only fragments cross the slow
    fabric (all-reduce over the pod axis); an all-gather inside the pod
    redistributes.  Slow-fabric traffic per GPU drops by ``chips_per_pod``×,
    the analogue of the paper's local processes never touching the RNIC.
    (The keys keep the reference's names: "dcn" is the slow fabric.)
    """
    n = pods * chips_per_pod
    flat_dcn = allreduce_wire_bytes(grad_bytes, n)  # worst-case: ring over the slow fabric
    cohort_dcn = allreduce_wire_bytes(grad_bytes / chips_per_pod, pods)
    return {
        "flat_dcn_bytes_per_chip": flat_dcn,
        "cohort_dcn_bytes_per_chip": cohort_dcn,
        "reduction": flat_dcn / cohort_dcn,
    }
