"""Deterministic step-cost model: FLOPs, bytes, wire traffic, MFU.

The counterpart of ``paddle2_tpu/observability/cost_model.py``, with the
same public names. Wall clocks conflate the thing that changed with
whatever else the host runs, so the cost model is **cost x rate**:
deterministic op accounting of the step itself, times a hardware rate
model.

* :func:`program_cost` — the FLOPs of one call of a step, counted by
  ``torch.utils.flop_counter.FlopCounterMode`` (where the JAX package
  reads XLA's ``cost_analysis`` of the compiled program). The counter
  counts matrix products and convolutions by their shapes, and the
  port's flash attention ops (``paddle2_tpu_torch::flash_attn`` and
  ``::flash_attn_varlen``, forward and backward) by the formulas that
  :mod:`paddle2_tpu_torch.kernels.flash_attn` and
  :mod:`~paddle2_tpu_torch.kernels.flash_varlen` register; a kernel
  bound through its C interface (AdamW, the norms) counts zero, as
  ``bench.py``'s formula counts no optimizer. It counts no bytes: the
  result has no ``"bytes accessed"``.
* :func:`wire_bytes` — algorithm bytes-on-wire per rank for each
  collective kind (ring all_reduce moves ``2(n-1)/n`` of the payload,
  gather/scatter variants ``(n-1)/n``, ...).
* :class:`LinkModel` — per-mesh-axis bandwidth: NVLink inside a node
  against InfiniBand across nodes, under the JAX package's record keys
  ``"ici"`` and ``"dcn"``, which now mean the in-node and the
  cross-node link.
* :class:`CollectiveTraffic` — an accumulator of collective dispatches;
  converts to seconds under a :class:`LinkModel`.
* :class:`StepCost` — joins FLOPs + HBM bytes + wire traffic into a
  roofline (compute-, memory- or network-bound), MFU against the card's
  peak, and a deterministic step-time lower bound.

**Rates.** :data:`CHIP_PEAKS` is keyed by the card's name, as
``torch.cuda.get_device_name`` gives it (lower case, a substring):
the NVIDIA H100 SXM's data sheet figures, 989e12 FLOP/s dense in
bf16/f16 and 3.35e12 B/s of HBM3, 80 GB. No TPU figure is carried
over. The CPU keeps a deliberately round nominal pair, so an MFU off a
card is obviously synthetic. A CUDA card that is not in the table takes
``PADDLE_PEAK_TFLOPS`` and ``PADDLE_HBM_GBPS``; without both,
:func:`chip_peak` raises ``ValueError`` naming them. The link and host
defaults are nominal specifications of the H100 SXM's node (NVLink 4,
one NDR InfiniBand port per card, PCIe Gen5 x16), not measurements.

The module imports torch only inside the functions that read a device
or count a step, so the tools and the arithmetic work without it.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# -- hardware rate tables ------------------------------------------------
# dense bf16/f16 peak per card (FLOP/s) and HBM bandwidth (B/s), keyed
# on lower-case substrings of torch.cuda.get_device_name; env-overridable
CHIP_PEAKS: Dict[str, Tuple[float, float]] = {
    # NVIDIA H100 SXM5 80 GB (data sheet, dense, at its 700 W limit):
    # torch names it "NVIDIA H100 80GB HBM3"
    "h100 80gb hbm3": (989e12, 3.35e12), "h100 sxm": (989e12, 3.35e12),
}
# HBM capacity per card (GB, the data sheet's); chip_hbm_gb reads the
# card's own total_memory, which the CUDA runtime's own reservations may lower
CHIP_HBM_GB: Dict[str, float] = {
    "h100 80gb hbm3": 80.0, "h100 sxm": 80.0,
}
# CPU: a deliberately round nominal figure so MFU numbers off a card are
# obviously synthetic rather than silently wrong
_CPU_PEAK = (1e11, 5e10)

PEAK_ENV = "PADDLE_PEAK_TFLOPS"
HBM_ENV = "PADDLE_HBM_GBPS"
HBM_CAPACITY_ENV = "PADDLE_HBM_CAPACITY_GB"
ICI_ENV = "PADDLE_ICI_GBPS"
DCN_ENV = "PADDLE_DCN_GBPS"
ICI_LATENCY_ENV = "PADDLE_ICI_LATENCY_US"
DCN_LATENCY_ENV = "PADDLE_DCN_LATENCY_US"
DCN_AXES_ENV = "PADDLE_DCN_AXES"

# nominal link rates (specifications, per direction, not measurements)
# of an H100 SXM node: NVLink 4 gives each card 900 GB/s both ways
# (450 one way) to the others of its host ("ici"); one NDR InfiniBand
# port per card carries 400 Gb/s (50 GB/s one way) across nodes ("dcn").
# One shared pair of names, so every caller prices with the same rates
DEFAULT_ICI_GBPS = 450.0
DEFAULT_DCN_GBPS = 50.0
_DEFAULT_ICI_GBPS = DEFAULT_ICI_GBPS
_DEFAULT_DCN_GBPS = DEFAULT_DCN_GBPS
# per-dispatch collective setup cost (the α of an α+β link model):
# assumed orders of magnitude for one NCCL dispatch inside a node and
# across nodes, neither a specification nor a measurement. LinkModel
# defaults its latencies to ZERO; a caller that wants latency-aware
# accounting opts in with these (or via env)
DEFAULT_ICI_LATENCY_US = 2.0
DEFAULT_DCN_LATENCY_US = 10.0

# host-offload link: PCIe Gen5 x16 (nominal 64 GB/s one way, a
# specification) between an H100 and its host. Owned here so the remat
# offload policy (incubate/autotune.py) and the serving KV spill tier
# price the SAME channel from one pair of names
HOST_ENV = "PADDLE_OFFLOAD_GBPS"
DEFAULT_HOST_GBPS = 64.0
_DEFAULT_HOST_GBPS = DEFAULT_HOST_GBPS


def host_link_bps(override_gbps=None) -> float:
    """Host<->device offload-link rate in bytes/s (env-overridable).

    ``override_gbps`` (GB/s) wins over the ``PADDLE_OFFLOAD_GBPS`` env
    var, which wins over :data:`DEFAULT_HOST_GBPS`."""
    if override_gbps is not None:
        return float(override_gbps) * 1e9
    return float(os.environ.get(HOST_ENV, DEFAULT_HOST_GBPS)) * 1e9


def _device(device):
    """``device`` as a ``torch.device``: None is card 0 when CUDA is
    available, else the CPU; an int is a card's index."""
    import torch
    if device is None:
        return torch.device("cuda", 0) if torch.cuda.is_available() \
            else torch.device("cpu")
    if isinstance(device, int):
        return torch.device("cuda", device)
    return torch.device(device)


def chip_peak(device=None) -> Tuple[float, float, str]:
    """(peak_flops, hbm_bytes_per_s, label) for ``device`` (default:
    card 0, else the CPU's nominal figure). ``PADDLE_PEAK_TFLOPS`` and
    ``PADDLE_HBM_GBPS`` override each figure on their own; a CUDA card
    that :data:`CHIP_PEAKS` does not name needs both, or this raises
    ``ValueError``."""
    env_peak = os.environ.get(PEAK_ENV)
    env_hbm = os.environ.get(HBM_ENV)
    if env_peak and env_hbm:
        return (float(env_peak) * 1e12, float(env_hbm) * 1e9,
                "env-override")
    dev = _device(device)
    platform = dev.type
    if platform == "cuda":
        import torch
        kind = torch.cuda.get_device_name(dev)
    else:
        kind = ""
    low = kind.lower()
    peak, hbm, label = None, None, ""
    for key, (p, h) in CHIP_PEAKS.items():
        if key in low:
            peak, hbm, label = p, h, key
            break
    if peak is None:
        if platform != "cuda":
            (peak, hbm), label = _CPU_PEAK, f"cpu-nominal({platform})"
        else:
            raise ValueError(
                f"no peak rates for the card {kind!r}: set {PEAK_ENV} "
                f"(dense bf16 TFLOP/s) and {HBM_ENV} (HBM GB/s)")
    # each override applies independently (an operator may know only
    # one of the two figures)
    if env_peak:
        peak, label = float(env_peak) * 1e12, label + "+peak-env"
    if env_hbm:
        hbm, label = float(env_hbm) * 1e9, label + "+hbm-env"
    return peak, hbm, label


def chip_hbm_gb(device=None) -> float:
    """Device memory (GB, 1e9 bytes) of ``device`` (default card 0):
    ``PADDLE_HBM_CAPACITY_GB`` overrides; a CUDA card reports its own
    ``total_memory``. The CPU has no such figure and raises
    ``ValueError`` naming the variable."""
    env = os.environ.get(HBM_CAPACITY_ENV)
    if env:
        return float(env)
    dev = _device(device)
    if dev.type != "cuda":
        raise ValueError(f"no device memory figure off a CUDA card: set "
                         f"{HBM_CAPACITY_ENV}")
    import torch
    return torch.cuda.get_device_properties(dev).total_memory / 1e9


# -- program accounting --------------------------------------------------
def cost_analysis_of(counter) -> Dict[str, float]:
    """One flat dict of floats from a ``FlopCounterMode`` that ran:
    ``{"flops": total}`` and, for each op that counted, ``"flops
    <op>"`` (the JAX function normalizes XLA's ``cost_analysis`` the
    same way)."""
    by_op = counter.get_flop_counts().get("Global", {})
    out = {"flops": float(counter.get_total_flops())}
    out.update({f"flops {op}": float(n)
                for op, n in sorted(by_op.items(), key=lambda kv: str(kv[0]))})
    return out


def program_cost(entry, call_args: Sequence[Any]
                 ) -> Optional[Dict[str, float]]:
    """The FLOPs of ONE call of ``entry(*call_args)``, counted by
    ``torch.utils.flop_counter.FlopCounterMode``: ``{"flops": total,
    "flops <op>": ...}`` (:func:`cost_analysis_of`), or None when the
    call counted nothing. The call runs, with every side effect it has
    (a train step updates its parameters), and adds no synchronization
    of its own. Deterministic: the count follows the shapes."""
    from torch.utils.flop_counter import FlopCounterMode
    from ..kernels import flash_attn, flash_varlen  # noqa: F401  (formulas)
    counter = FlopCounterMode(display=False)
    with counter:
        entry(*call_args)
    out = cost_analysis_of(counter)
    return out if out["flops"] else None


def abstractify(call_args: Sequence[Any]) -> List[Any]:
    """Shape/dtype skeleton of ``call_args``: each tensor as an empty
    tensor of its shape and dtype on the ``meta`` device, safe to hold
    without holding the data."""
    import torch

    def _one(a):
        if isinstance(a, torch.Tensor):
            return torch.empty(a.shape, dtype=a.dtype, device="meta")
        return a
    return [_one(a) for a in call_args]


# -- collective traffic --------------------------------------------------
# bytes-on-wire factor per rank, as a multiple of the per-rank payload,
# for the bandwidth-optimal algorithm of each collective family
_WIRE_FACTORS = (
    ("all_reduce", lambda n: 2.0 * (n - 1) / n),
    ("reduce_scatter", lambda n: (n - 1) / n),
    ("all_gather", lambda n: (n - 1) / n),
    ("all_to_all", lambda n: (n - 1) / n),
    ("alltoall", lambda n: (n - 1) / n),
    ("broadcast", lambda n: (n - 1) / n),
    ("reduce", lambda n: (n - 1) / n),
    ("scatter", lambda n: (n - 1) / n),
    ("gather", lambda n: (n - 1) / n),
    ("ppermute", lambda n: 1.0),
    ("send", lambda n: 1.0),
    ("recv", lambda n: 1.0),
    ("barrier", lambda n: 0.0),
)


def wire_bytes(op: str, payload_bytes: float, group_size: int) -> float:
    """Per-rank bytes on the wire for one collective: payload x the
    algorithm factor. ``op`` matches by prefix (``all_reduce_sum`` ->
    ``all_reduce``). Unknown ops are charged the conservative full
    payload."""
    n = max(1, int(group_size))
    if n == 1:
        return 0.0
    for prefix, factor in _WIRE_FACTORS:
        if op.startswith(prefix):
            return float(payload_bytes) * factor(n)
    return float(payload_bytes)


class LinkModel:
    """Per-mesh-axis link α+β cost: latency (α, per dispatch) plus
    bandwidth (β, per byte), over two link classes that keep the JAX
    package's record keys so that the tools read both packages'
    streams: ``"ici"`` is now the link inside a node (NVLink between
    the cards of one host, :data:`DEFAULT_ICI_GBPS`) and ``"dcn"`` the
    link across nodes (InfiniBand, :data:`DEFAULT_DCN_GBPS`). An axis
    is in-node unless named in ``dcn_axes`` (default: any axis whose
    name contains ``"dcn"``, plus the ``PADDLE_DCN_AXES`` comma list).
    Where a docstring below says "slice", read "node".

    Latencies DEFAULT TO ZERO (a pure-bandwidth model); a latency-aware
    caller passes ``ici_latency_us``/``dcn_latency_us`` explicitly or
    sets the ``PADDLE_{ICI,DCN}_LATENCY_US`` env. The α term is what
    makes bucket sizing link-class-dependent: a latency-dominated
    cross-node hop wants FEWER, BIGGER buckets than NVLink."""

    def __init__(self, ici_gbps: Optional[float] = None,
                 dcn_gbps: Optional[float] = None,
                 dcn_axes: Optional[Iterable[str]] = None,
                 ici_latency_us: Optional[float] = None,
                 dcn_latency_us: Optional[float] = None):
        self.ici_bps = float(
            ici_gbps if ici_gbps is not None
            else os.environ.get(ICI_ENV, _DEFAULT_ICI_GBPS)) * 1e9
        self.dcn_bps = float(
            dcn_gbps if dcn_gbps is not None
            else os.environ.get(DCN_ENV, _DEFAULT_DCN_GBPS)) * 1e9
        self.ici_latency_s = float(
            ici_latency_us if ici_latency_us is not None
            else os.environ.get(ICI_LATENCY_ENV, 0.0)) * 1e-6
        self.dcn_latency_s = float(
            dcn_latency_us if dcn_latency_us is not None
            else os.environ.get(DCN_LATENCY_ENV, 0.0)) * 1e-6
        env_axes = os.environ.get(DCN_AXES_ENV, "")
        self.dcn_axes = set(a.strip() for a in env_axes.split(",")
                            if a.strip())
        if dcn_axes is not None:
            self.dcn_axes |= set(dcn_axes)

    def is_dcn(self, axis: Optional[str]) -> bool:
        if axis is None:
            return False
        return axis in self.dcn_axes or "dcn" in str(axis).lower()

    def link_class(self, axes: Sequence[str] = ()) -> str:
        """``"dcn"`` when the collective crosses ANY DCN-mapped axis
        (the slow hop gates the whole group), else ``"ici"``."""
        return "dcn" if any(self.is_dcn(a) for a in axes) else "ici"

    def bandwidth(self, axis: Optional[str]) -> float:
        return self.dcn_bps if self.is_dcn(axis) else self.ici_bps

    def latency(self, axes: Sequence[str] = ()) -> float:
        """Per-dispatch setup cost (α) of one collective over ``axes``:
        the slowest link class it crosses."""
        return (self.dcn_latency_s if self.link_class(axes) == "dcn"
                else self.ici_latency_s)

    def seconds(self, bytes_on_wire: float,
                axes: Sequence[str] = ()) -> float:
        """α+β time of ONE collective dispatch: setup latency plus
        transfer under the SLOWEST link it crosses (a multi-axis group
        is gated by its weakest hop). With the default zero latencies
        this is the pure-bandwidth figure it always was; multi-dispatch
        cost is modeled as one :class:`CollectiveTraffic` entry per
        dispatch."""
        if bytes_on_wire <= 0:
            return 0.0
        bw = min((self.bandwidth(a) for a in axes),
                 default=self.ici_bps)
        return float(bytes_on_wire) / bw + self.latency(axes)


def sparse_transfer_seconds(wire_bytes: float, link_class: str = "dcn",
                            link: Optional["LinkModel"] = None,
                            dispatches: int = 1,
                            host_gbps: Optional[float] = None) -> float:
    """α+β time of point-to-point sparse traffic (PS pull/push/delta)
    under one named link class, priced from the SAME LinkModel the
    collectives use so a sparse byte and a dense byte never drift.

    - ``"host"``: a worker talking to its co-located server — the
      PCIe-class :func:`host_link_bps` channel, no dispatch α (no
      fabric rendezvous on-host).
    - ``"dcn"`` / ``"ici"``: remote server — LinkModel bandwidth plus
      its per-dispatch latency, ``dispatches`` times (a pull fanning
      out to k remote shards pays k setups, not one).
    """
    if wire_bytes <= 0 and link_class == "host":
        return 0.0
    if link_class == "host":
        return float(wire_bytes) / host_link_bps(host_gbps)
    link = link or LinkModel()
    if link_class == "dcn":
        bw, alpha = link.dcn_bps, link.dcn_latency_s
    elif link_class == "ici":
        bw, alpha = link.ici_bps, link.ici_latency_s
    else:
        raise ValueError(f"unknown link class {link_class!r} "
                         "(expected host/ici/dcn)")
    return float(wire_bytes) / bw + alpha * max(1, int(dispatches))


class CollectiveTraffic:
    """Accumulator of per-step collective dispatches -> wire bytes and
    a deterministic transfer-time estimate.

    Each entry carries an ``overlappable`` mark: whether the program's
    schedule leaves independent compute for this collective to hide
    under (a bucketed grad reduce issued while backward still produces
    later buckets, a ZeRO-3 prefetch gather issued a layer ahead). The
    overlap split below is what turns "bytes on wire" into "EXPOSED
    wire time" — the only part of communication that actually extends
    the step."""

    def __init__(self):
        self.entries: List[Dict[str, Any]] = []

    def add(self, op: str, payload_bytes: float,
            axes: Sequence[str] = (), group_size: int = 1,
            overlappable: bool = False) -> None:
        self.entries.append({
            "op": op, "payload_bytes": float(payload_bytes),
            "axes": tuple(axes), "group_size": int(group_size),
            "overlappable": bool(overlappable),
            "wire_bytes": wire_bytes(op, payload_bytes, group_size)})

    def add_hierarchical_all_reduce(self, payload_bytes: float,
                                    ici_axes: Sequence[str],
                                    dcn_axes: Sequence[str],
                                    ici_group: int, dcn_group: int,
                                    overlappable: bool = False) -> None:
        """Price one HIERARCHICAL all-reduce (a gradient sync):
        in-slice reduce-scatter over the ICI axes, cross-slice
        all-reduce of the 1/ici_group partial shard over DCN, in-slice
        all-gather.
        Against a flat all-reduce over the combined group this trades
        ``2(n-1)/n × payload`` at DCN bandwidth for mostly-ICI traffic
        plus a DCN hop carrying only ``payload / ici_group``."""
        payload = float(payload_bytes)
        ici_n, dcn_n = max(1, int(ici_group)), max(1, int(dcn_group))
        self.add("reduce_scatter", payload, axes=ici_axes,
                 group_size=ici_n, overlappable=overlappable)
        self.add("all_reduce_sum", payload / ici_n, axes=dcn_axes,
                 group_size=dcn_n, overlappable=overlappable)
        self.add("all_gather", payload, axes=ici_axes,
                 group_size=ici_n, overlappable=overlappable)

    def add_all_to_all_matrix(self, pair_bytes: Sequence[Sequence[float]],
                              ranks_per_slice: int,
                              ici_axes: Sequence[str] = ("ici",),
                              dcn_axes: Sequence[str] = ("dcn",),
                              hierarchical: bool = False,
                              op: str = "moe_a2a",
                              overlappable: bool = False
                              ) -> Dict[str, int]:
        """Price one token-routing all-to-all from an EXACT per-pair
        byte matrix (``pair_bytes[src][dst]``, diagonal ignored) — the
        MoE dispatch/combine case, where the payload each rank owes each
        expert host is known from the step's routing decisions rather
        than assumed uniform. Ranks are grouped into ICI slices of
        ``ranks_per_slice`` consecutive ranks; a pair within a slice
        rides ICI, a cross-slice pair rides DCN.

        - **flat**: one point-to-point dispatch per nonzero pair — every
          cross-slice pair pays its own DCN α. At small per-expert
          payloads (a few KB of routed tokens) the α term dominates.
        - **hierarchical**: cross-slice payloads are bucketed per
          (src slice, dst slice) — each contributing rank forwards its
          chunk to the slice egress over ICI, ONE DCN dispatch carries
          the whole bucket, and the destination slice scatters it over
          ICI. Same bytes on the DCN, slice-pair-many α's instead of
          rank-pair-many (the ``add_hierarchical_all_reduce`` trade,
          applied to a2a).

        Returns the dispatch counts per link class (``{"ici": n,
        "dcn": n}``) so a lane can gate α-dominance explicitly. Entries
        use ``group_size=2`` so the point-to-point payload is charged in
        full (``group_size=1`` means "no wire" to :func:`wire_bytes`).
        """
        n = len(pair_bytes)
        rps = max(1, int(ranks_per_slice))
        counts = {"ici": 0, "dcn": 0}

        def _p2p(suffix: str, b: float, axes: Sequence[str],
                 cls: str) -> None:
            self.add(f"{op}_{suffix}", b, axes=axes, group_size=2,
                     overlappable=overlappable)
            counts[cls] += 1

        buckets: Dict[Tuple[int, int], float] = {}
        for i in range(n):
            for j in range(n):
                if i == j:
                    continue
                b = float(pair_bytes[i][j])
                if b <= 0:
                    continue
                si, sj = i // rps, j // rps
                if si == sj:
                    _p2p("p2p", b, ici_axes, "ici")
                elif not hierarchical:
                    _p2p("p2p", b, dcn_axes, "dcn")
                else:
                    # slice-local gather hop to the egress rank, then
                    # the mirrored scatter hop at the destination; the
                    # DCN bucket itself is added once per slice pair
                    _p2p("gather_ici", b, ici_axes, "ici")
                    _p2p("scatter_ici", b, ici_axes, "ici")
                    buckets[(si, sj)] = buckets.get((si, sj), 0.0) + b
        for (_si, _sj), b in sorted(buckets.items()):
            _p2p("bucket", b, dcn_axes, "dcn")
        return counts

    def add_ring_hops(self, block_bytes: float,
                      member_slices: Sequence[int],
                      rotations: Optional[int] = None,
                      ici_axes: Sequence[str] = ("ici",),
                      dcn_axes: Sequence[str] = ("dcn",),
                      op: str = "sep_ring",
                      overlappable: bool = False) -> Dict[str, int]:
        """Price a ring-attention K/V rotation schedule: on
        every rotation step each ring member forwards its currently-held
        K/V block to its successor, so one rotation is ``len(members)``
        point-to-point hops of ``block_bytes`` each, and a full pass is
        ``rotations`` (default ``n - 1``) such steps. ``member_slices``
        gives the ICI-slice id of each member IN RING ORDER — the ring
        ORDER is the scheduling lever this method exposes: a
        slice-contiguous order pays one DCN α per slice boundary per
        rotation, while an interleaved ("flat") order pays one per hop.
        Entries use ``group_size=2`` (point-to-point, full payload on
        the wire). Returns dispatch counts per link class, mirroring
        :meth:`add_all_to_all_matrix`, so a lane can gate α-dominance
        of the two orders both ways.
        """
        members = list(member_slices)
        n = len(members)
        if n < 2:
            return {"ici": 0, "dcn": 0}
        rot = (n - 1) if rotations is None else max(0, int(rotations))
        counts = {"ici": 0, "dcn": 0}
        for _ in range(rot):
            for m in range(n):
                same = members[m] == members[(m + 1) % n]
                if same:
                    self.add(f"{op}_hop_ici", block_bytes, axes=ici_axes,
                             group_size=2, overlappable=overlappable)
                    counts["ici"] += 1
                else:
                    self.add(f"{op}_hop_dcn", block_bytes, axes=dcn_axes,
                             group_size=2, overlappable=overlappable)
                    counts["dcn"] += 1
        return counts

    def wire_bytes_total(self) -> float:
        return sum(e["wire_bytes"] for e in self.entries)

    def payload_bytes_total(self) -> float:
        return sum(e["payload_bytes"] for e in self.entries)

    def overlappable_wire_bytes(self) -> float:
        return sum(e["wire_bytes"] for e in self.entries
                   if e["overlappable"])

    def exposed_wire_bytes(self) -> float:
        return sum(e["wire_bytes"] for e in self.entries
                   if not e["overlappable"])

    def seconds(self, link: Optional[LinkModel] = None) -> float:
        link = link or LinkModel()
        return sum(link.seconds(e["wire_bytes"], e["axes"])
                   for e in self.entries)

    def _entry_split(self, e: Dict[str, Any], link: LinkModel
                     ) -> Tuple[str, float, float]:
        """ONE owner of the α+β exposure rule, shared by
        :meth:`overlap_split` and :meth:`overlap_split_by_class`:
        returns ``(link_class, hideable_s, always_exposed_s)`` for one
        entry. A non-overlappable dispatch is fully exposed; an
        overlappable one hides only its bandwidth term — per-dispatch
        setup latency (α) is fabric round-trip time pipelining cannot
        absorb."""
        s = link.seconds(e["wire_bytes"], e["axes"])
        cls = link.link_class(e["axes"])
        if not e["overlappable"]:
            return cls, 0.0, s
        alpha = link.latency(e["axes"]) if s > 0 else 0.0
        return cls, s - alpha, alpha

    def overlap_split(self, link: Optional[LinkModel] = None,
                      compute_s: float = 0.0) -> Dict[str, float]:
        """Split this step's wire time into EXPOSED vs HIDDEN given the
        link model and the compute time available as overlap budget.

        Deterministic model: overlappable entries hide under compute up
        to ``compute_s`` total (the latency-hiding scheduler cannot
        conjure more independent compute than the step has);
        non-overlappable entries are always exposed. Under an α+β link
        model only the BANDWIDTH term of an overlappable dispatch is
        hideable — per-dispatch latency is fabric/setup round-trip time
        that pipelining cannot absorb, so every dispatch's α counts as
        exposed (this is what makes bucket COUNT a real cost on
        latency-dominated DCN links; with the default zero latencies it
        changes nothing). Returns ``{"serial_s", "hideable_s",
        "hidden_s", "exposed_s"}`` with ``serial_s == hidden_s +
        exposed_s`` exactly."""
        link = link or LinkModel()
        hideable = 0.0
        base_exposed = 0.0
        for e in self.entries:
            _cls, h, x = self._entry_split(e, link)
            hideable += h
            base_exposed += x
        hidden = min(hideable, max(0.0, float(compute_s)))
        return {"serial_s": hideable + base_exposed,
                "hideable_s": hideable,
                "hidden_s": hidden,
                "exposed_s": base_exposed + (hideable - hidden)}

    def overlap_split_by_class(self, link: Optional[LinkModel] = None,
                               compute_s: float = 0.0
                               ) -> Dict[str, Dict[str, float]]:
        """The :meth:`overlap_split` attribution broken out PER LINK
        CLASS (``"ici"`` vs ``"dcn"``), so a cross-slice DCN overlap
        regression is nameable as such instead of collapsing into one
        exposed-comm number. The hidden budget (what compute can
        absorb) is allocated to each class proportionally to its
        hideable wire time — deterministic, and the class figures sum
        to the aggregate split's ``hidden_s``/``exposed_s`` exactly up
        to float addition."""
        link = link or LinkModel()
        hideable = {"ici": 0.0, "dcn": 0.0}
        base_exposed = {"ici": 0.0, "dcn": 0.0}
        for e in self.entries:
            cls, h, x = self._entry_split(e, link)
            hideable[cls] += h
            base_exposed[cls] += x
        total_hideable = hideable["ici"] + hideable["dcn"]
        hidden_total = min(total_hideable, max(0.0, float(compute_s)))
        out: Dict[str, Dict[str, float]] = {}
        for cls in ("ici", "dcn"):
            share = (hideable[cls] / total_hideable
                     if total_hideable > 0 else 0.0)
            hidden = hidden_total * share
            out[cls] = {
                "serial_s": hideable[cls] + base_exposed[cls],
                "hideable_s": hideable[cls],
                "hidden_s": hidden,
                "exposed_s": base_exposed[cls] + (hideable[cls] - hidden),
            }
        return out

    def by_op(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.entries:
            out[e["op"]] = out.get(e["op"], 0.0) + e["wire_bytes"]
        return out


class StepCost:
    """One compiled step's deterministic cost: program FLOPs + HBM
    bytes + wire traffic -> roofline verdict, time lower bound, MFU."""

    def __init__(self, flops: float, hbm_bytes: float = 0.0,
                 traffic: Optional[CollectiveTraffic] = None,
                 link: Optional[LinkModel] = None,
                 peak_flops: Optional[float] = None,
                 hbm_bps: Optional[float] = None):
        if peak_flops is None or hbm_bps is None:
            p, h, self.chip = chip_peak()
            peak_flops = peak_flops if peak_flops is not None else p
            hbm_bps = hbm_bps if hbm_bps is not None else h
        else:
            self.chip = "caller-supplied"
        self.flops = float(flops)
        self.hbm_bytes = float(hbm_bytes)
        self.traffic = traffic or CollectiveTraffic()
        self.link = link or LinkModel()
        self.peak_flops = float(peak_flops)
        self.hbm_bps = float(hbm_bps)

    def compute_s(self) -> float:
        return self.flops / self.peak_flops if self.peak_flops else 0.0

    def memory_s(self) -> float:
        return self.hbm_bytes / self.hbm_bps if self.hbm_bps else 0.0

    def network_s(self) -> float:
        return self.traffic.seconds(self.link)

    def overlap(self) -> Dict[str, float]:
        """The exposed/hidden wire-time split under this step's own
        compute budget (``CollectiveTraffic.overlap_split``)."""
        return self.traffic.overlap_split(self.link, self.compute_s())

    def exposed_network_s(self) -> float:
        """Wire time that actually EXTENDS the step: non-overlappable
        collectives plus whatever overlappable wire time exceeds the
        compute available to hide it."""
        return self.overlap()["exposed_s"]

    def exposed_network_by_class(self) -> Dict[str, float]:
        """Exposed wire time split by link class:
        ``{"ici": s, "dcn": s}`` (``overlap_split_by_class`` under this
        step's own compute budget) — the per-class lane perf_doctor
        reports next to the aggregate exposed-comm %."""
        split = self.traffic.overlap_split_by_class(
            self.link, self.compute_s())
        return {cls: split[cls]["exposed_s"] for cls in ("ici", "dcn")}

    def exposed_comm_fraction(self) -> float:
        """Exposed wire time as a fraction of the modeled step
        (``exposed / (max(compute, memory) + exposed)``) — the number
        perf_doctor reports as exposed-comm %."""
        t = self.step_time_modeled_s()
        return self.exposed_network_s() / t if t > 0 else 0.0

    def step_time_modeled_s(self) -> float:
        """Schedule-aware step-time model: compute (or HBM, whichever
        binds) runs back-to-back while overlappable collectives hide
        under it; only EXPOSED wire time extends the step. This is the
        cost x rate number to compare across card counts —
        deterministic, no wall clock anywhere."""
        return max(self.compute_s(), self.memory_s()) \
            + self.exposed_network_s()

    def step_time_lower_bound_s(self) -> float:
        """Perfect-overlap model: the step cannot run faster than its
        slowest resource."""
        return max(self.compute_s(), self.memory_s(), self.network_s())

    def bound(self) -> str:
        times = {"compute": self.compute_s(), "memory": self.memory_s(),
                 "network": self.network_s()}
        return max(times, key=times.get)

    def arithmetic_intensity(self) -> Optional[float]:
        if not self.hbm_bytes:
            return None
        return self.flops / self.hbm_bytes

    def ridge_point(self) -> float:
        """FLOP/byte where the chip flips memory- to compute-bound."""
        return self.peak_flops / self.hbm_bps if self.hbm_bps else 0.0

    def mfu(self, measured_step_s: float) -> Optional[float]:
        """Model FLOPs utilization against the chip peak for a measured
        step time (the ONE place a wall clock enters — supplied by the
        caller, typically a metrics-plane step record)."""
        if measured_step_s <= 0 or not self.peak_flops:
            return None
        return self.flops / (self.peak_flops * measured_step_s)

    def roofline(self) -> Dict[str, Any]:
        ai = self.arithmetic_intensity()
        ov = self.overlap()
        by_class = self.exposed_network_by_class()
        return {
            "exposed_network_ici_s": by_class["ici"],
            "exposed_network_dcn_s": by_class["dcn"],
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "wire_bytes": self.traffic.wire_bytes_total(),
            "compute_s": self.compute_s(),
            "memory_s": self.memory_s(),
            "network_s": self.network_s(),
            "exposed_network_s": ov["exposed_s"],
            "hidden_network_s": ov["hidden_s"],
            "exposed_comm_fraction": self.exposed_comm_fraction(),
            "step_time_modeled_s": self.step_time_modeled_s(),
            "step_time_lower_bound_s": self.step_time_lower_bound_s(),
            "bound": self.bound(),
            "arithmetic_intensity": ai,
            "ridge_point": self.ridge_point(),
            "chip": self.chip,
        }


def pipeline_bubble_fraction(pp: int, microbatches: int,
                             virtual_stages: int = 1) -> float:
    """Idle-fraction of the 1F1B pipeline schedule as a multiple of the
    useful compute: ``(p - 1) / (v * m)`` — the Megatron interleaved-VPP
    figure (non-interleaved at v=1 is the classic ``(p-1)/m``). With
    ``v`` virtual stages per device each warmup/cooldown slot costs
    ``1/v`` of a full stage."""
    p, m, v = int(pp), int(microbatches), int(virtual_stages)
    if p <= 1:
        return 0.0
    if m < 1 or v < 1:
        raise ValueError(
            f"pipeline_bubble_fraction: microbatches={m} and "
            f"virtual_stages={v} must be >= 1")
    return (p - 1) / float(v * m)


class PhasedStepCost:
    """A step modeled as a SEQUENCE of roofline phases.

    One :class:`StepCost` folds the whole program into a single
    ``max(compute, memory)`` — fine for matmul-dominated fwd+bwd, but
    it hides serial tails whose binding resource differs: the
    optimizer update is HBM-bound and runs strictly AFTER the last
    gradient; remat recompute is extra backward work the matmul phase
    cannot absorb. Each phase is its own roofline and the step is the
    SUM — the accounting the perf_doctor MFU lane reads."""

    def __init__(self):
        self.phases: List[Tuple[str, StepCost]] = []

    def add(self, name: str, cost: StepCost) -> "PhasedStepCost":
        self.phases.append((name, cost))
        return self

    def step_time_modeled_s(self) -> float:
        return sum(c.step_time_modeled_s() for _, c in self.phases)

    def flops(self) -> float:
        return sum(c.flops for _, c in self.phases)

    def hbm_bytes(self) -> float:
        return sum(c.hbm_bytes for _, c in self.phases)

    def mfu_modeled(self) -> Optional[float]:
        """Model FLOPs over the chip peak for the MODELED step time —
        the deterministic MFU ceiling of this program shape (the
        number the perf_doctor MFU lane aggregates). Uses the FIRST
        phase's peak (phases share a chip)."""
        t = self.step_time_modeled_s()
        if not self.phases or t <= 0:
            return None
        peak = self.phases[0][1].peak_flops
        return self.flops() / (peak * t) if peak else None

    def breakdown(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for name, c in self.phases:
            out[name] = {
                "flops": c.flops, "hbm_bytes": c.hbm_bytes,
                "compute_s": c.compute_s(), "memory_s": c.memory_s(),
                "step_time_modeled_s": c.step_time_modeled_s(),
                "bound": c.bound()}
        return out

    def step_record_fields(self) -> Dict[str, float]:
        """The metrics-plane step-record lane: stamp these through
        ``metrics.step_end(**fields)`` and ``perf_doctor`` renders the
        MFU/roofline columns (aggregated only when every rank carries
        them)."""
        peak = self.phases[0][1].peak_flops if self.phases else 0.0
        return {"modeled_step_s": self.step_time_modeled_s(),
                "roofline_s": self.step_time_modeled_s(),
                "modeled_flops": self.flops(),
                "peak_flops": peak}


def step_cost_of_program(program, link: Optional[LinkModel] = None
                         ) -> Optional[StepCost]:
    """Build a :class:`StepCost` from a
    :class:`~paddle2_tpu_torch.jit.train_step.TrainStepProgram` whose
    last call ran with ``collect_cost = True`` (it stashed that call's
    :func:`program_cost` as ``last_cost``); None when it has none."""
    ca = getattr(program, "last_cost", None)
    if not ca:
        return None
    return StepCost(flops=ca.get("flops", 0.0),
                    hbm_bytes=ca.get("bytes accessed", 0.0),
                    link=link)


__all__ = ["CHIP_PEAKS", "CHIP_HBM_GB", "chip_peak", "chip_hbm_gb",
           "cost_analysis_of", "program_cost",
           "abstractify", "wire_bytes", "sparse_transfer_seconds",
           "LinkModel", "CollectiveTraffic",
           "StepCost", "PhasedStepCost", "step_cost_of_program",
           "pipeline_bubble_fraction",
           "DEFAULT_ICI_GBPS", "DEFAULT_DCN_GBPS",
           "DEFAULT_ICI_LATENCY_US", "DEFAULT_DCN_LATENCY_US",
           "DEFAULT_HOST_GBPS", "HOST_ENV", "host_link_bps",
           "PEAK_ENV", "HBM_ENV", "ICI_ENV", "DCN_ENV", "DCN_AXES_ENV",
           "ICI_LATENCY_ENV", "DCN_LATENCY_ENV", "HBM_CAPACITY_ENV"]
