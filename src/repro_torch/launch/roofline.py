"""Roofline terms of a counted step on NVIDIA H100s: the port's
counterpart of the JAX package's ``launch/roofline.py``.

Hardware model: one H100 SXM a rank, NVIDIA's data sheets (dense rates,
no sparsity, at the 700 W power limit; a card set below it runs slower):

  compute term    = sum over dtypes of FLOPs / that dtype's peak rate
  memory term     = bytes / HBM rate
  collective term = wire bytes in one node / NVLink rate
                    + the other wire bytes / InfiniBand rate

all a rank's (rank 0's, counted on meta). One card (``MESH``) has no
collective term. On a mesh the ranks are numbered row-major over its
axes and a node holds 8 consecutive ranks (DGX H100), so a group lies in
one node only where its axes are the minor ones and hold at most 8
ranks: at the JAX package's production meshes, 16 x 16 and 2 x 16 x 16,
every axis's group (16 ranks or more) spans nodes and every collective
takes the InfiniBand rate.

The f32 rate is the CUDA cores' unless ``torch.backends.cuda.matmul
.allow_tf32`` is on when the step is counted; then f32 matmuls may run
on the tensor cores at the TF32 rate, and ``f32_rate`` records which.
The kernels' f32 work (``work()``) counts at that rate too, whichever
instructions they use. The counts come from ``launch/op_analysis.py``.
"""
from __future__ import annotations

import dataclasses

import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3, NVIDIA's data sheet
BF16_FLOP_PER_S = 989e12         # bf16 (and fp16) on the tensor cores, dense
TF32_FLOP_PER_S = 495e12         # TF32 on the tensor cores, dense
F32_FLOP_PER_S = 67e12           # f32 on the CUDA cores
CARD_BYTES = 80e9                # HBM of one card
FIT_SHARE = 0.9                  # what a step may hold of it: 72 GB
MESH = "1xH100"
# NVLink 4 between the 8 cards of a node: 900 GB/s a card, both
# directions together (H100 SXM data sheet), so 450 GB/s a direction
NVLINK_BYTES_PER_S = 450e9
# between nodes: one 400 Gb/s InfiniBand NIC (ConnectX-7) a card (DGX
# H100 data sheet), 50 GB/s a direction
IB_BYTES_PER_S = 50e9


def flop_rate(dtype: str, f32_rate: float) -> float:
    """Peak FLOP/s for FLOPs of ``dtype`` (a dtype's name): bf16 and fp16
    on the tensor cores, f32 at ``f32_rate``, the rest (integer or f64
    work) at the f32 rate."""
    if dtype in ("bfloat16", "float16"):
        return BF16_FLOP_PER_S
    return f32_rate


def current_f32_rate() -> float:
    """The f32 rate under the current TF32 setting."""
    return TF32_FLOP_PER_S if torch.backends.cuda.matmul.allow_tf32 \
        else F32_FLOP_PER_S


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_detail: dict
    peak_memory_per_chip: float
    model_flops: float
    quad_bytes_per_chip: float = 0.0
    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    f32_rate: float = F32_FLOP_PER_S
    # the wire bytes of collectives whose group lies in one node
    coll_bytes_in_node: float = 0.0

    @property
    def t_compute(self) -> float:
        return sum(f / flop_rate(dt, self.f32_rate)
                   for dt, f in self.flops_by_dtype.items())

    @property
    def peak_flops(self) -> float:
        """The rate of the dtype that holds the most FLOPs."""
        if not self.flops_by_dtype:
            return self.f32_rate
        top = max(self.flops_by_dtype, key=self.flops_by_dtype.get)
        return flop_rate(top, self.f32_rate)

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / HBM_BYTES_PER_S

    @property
    def t_memory_flash(self) -> float:
        """Memory term with attention-quadratic tensor traffic removed: the
        JAX package's projection of a flash kernel that keeps the [Sq, Sk]
        tiles on chip. In the port the LM's unmasked layers run the flash
        kernel already, so their tiles are not in the count; what is left
        is the plain paths' (masked attention)."""
        return max(self.bytes_per_chip - self.quad_bytes_per_chip, 0.0) \
            / HBM_BYTES_PER_S

    @property
    def t_collective(self) -> float:
        """The wire bytes a rank at NVLink's rate in one node, at
        InfiniBand's across nodes."""
        across = self.coll_bytes_per_chip - self.coll_bytes_in_node
        return self.coll_bytes_in_node / NVLINK_BYTES_PER_S \
            + across / IB_BYTES_PER_S

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lb(self) -> float:
        """Lower-bound step time = max of the three terms (perfect overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs: a remat and redundancy detector."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_upper_bound(self) -> float:
        """MODEL_FLOPS / (chips * peak_flops * step_time_lb)."""
        denom = self.chips * self.peak_flops * self.step_time_lb
        return self.model_flops / denom if denom else 0.0

    @property
    def fits_one_card(self) -> bool:
        """Whether the step's peak live bytes fit 90% of one card's 80 GB."""
        return self.peak_memory_per_chip <= FIT_SHARE * CARD_BYTES

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_detail": self.coll_detail,
            "peak_memory_per_chip": self.peak_memory_per_chip,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_memory_flash": self.t_memory_flash,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "step_time_lb": self.step_time_lb,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_upper_bound": self.mfu_upper_bound,
        }


def coll_detail(count: dict) -> dict:
    """The JAX package's ``coll_detail`` from a count: the wire bytes by
    kind, ``n_<kind>`` and ``operand_convention_total``."""
    out = dict(count.get("coll_wire", {}))
    out.update({f"n_{k}": v for k, v in count.get("coll_count", {}).items()})
    out["operand_convention_total"] = count.get("coll_operand_total", 0.0)
    return out


def from_count(cell, count: dict, f32_rate: float | None = None,
               mesh=None) -> Roofline:
    """The roofline of ``cell`` from ``op_analysis.OpCounter.result()``;
    ``f32_rate`` is the one the step was counted under (the current TF32
    setting's by default). ``mesh`` (``launch/mesh.py``), where the count
    is one rank's: its name (``"16x16"``), its world as ``chips`` and the
    count's collective bytes; None is one card (``MESH``), no collective
    term."""
    return Roofline(
        arch=cell.arch, shape=cell.shape,
        mesh=MESH if mesh is None else mesh.name,
        chips=1 if mesh is None else mesh.world,
        flops_per_chip=float(count["flops"]),
        bytes_per_chip=float(count["bytes"]),
        coll_bytes_per_chip=float(count.get("coll_wire_total", 0.0)),
        coll_detail=coll_detail(count) if mesh is not None else {},
        peak_memory_per_chip=float(count["peak_bytes"]),
        model_flops=float(cell.meta.get("model_flops", 0.0)),
        quad_bytes_per_chip=float(count["quad_bytes"]),
        flops_by_dtype=dict(count["flops_by_dtype"]),
        f32_rate=current_f32_rate() if f32_rate is None else f32_rate,
        coll_bytes_in_node=float(count.get("coll_wire_in_node", 0.0)))
