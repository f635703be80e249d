"""GPU machine/topology model for the cost simulator.

The counterpart of ``flexflow_tpu.search.machine_model.TPUMachineModel``
(reference: the MachineModel hierarchy, include/flexflow/simulator.h:
212-606, src/runtime/machine_model.cc). ``GPUMachineModel`` keeps the JAX
class's dataclass field names and its collective formulas
(``allreduce_time``, ``allgather_time``, ``alltoall_time``, ``p2p_time``
and the ``hier_*`` forms) unchanged, so the same field values give the
same prices in both packages. The fields read, for a GPU:

* per card: the dense 16-bit peak (``peak_flops``), the fp32 peak
  (``peak_flops_f32``: the card's non-tensor rate, since the port runs
  IEEE fp32 with TF32 off), the rate of an fp32 matmul
  (``matmul_flops_f32``, the port's alone: the same rate on a card's
  entry, 0 for the JAX rule), HBM bandwidth and capacity;
* ``ici_*``: NVLink / NVSwitch inside a node (PCIe where the ranks'
  devices have no peer access). A switch joins every card of a node, so
  ``torus`` is one ring of the node's cards, ``ici_links_per_chip`` is 2
  (the ring's two directions) and ``ici_bandwidth`` half the card's
  per-direction NVLink rate: a ring collective then moves its bytes at the
  card's whole per-direction rate;
* ``dcn_*``: the network between nodes, per node (the NICs a node's cards
  share).

``generation`` names the card (``h100-sxm``, ``h100-pcie``, ``h100-nvl``).
``matmul_efficiency``, ``hbm_efficiency`` and ``update_hbm_efficiency``
are fractions measured on the card by ``chip_smoke.py``'s phase 17 (a
large GEMM against the peak, an elementwise pass and the port's Adam
update against the HBM rate). Version selection mirrors the reference
(graph.cc:1908-1922): ``machine_model_version == 0`` -> :meth:`detect`;
``1`` -> :meth:`from_file` (``--machine-model-file``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

# per card: (dense fp32 FLOP/s without tensor cores, HBM bytes/s, HBM GiB,
#            NVLink bytes/s per direction, the ``PEAK_FLOPS`` key of
#            obs/telemetry that holds the dense 16-bit peak). NVIDIA H100
# data sheet figures: SXM 67 TF/s fp32, 3.35 TB/s, 80 GB, NVLink 900 GB/s
# both ways; PCIe 51 TF/s, 2.0 TB/s, 80 GB, a bridge of 600 GB/s; NVL
# 60 TF/s, 3.9 TB/s, 94 GB, 600 GB/s.
GPU_GENERATIONS = {
    "h100-sxm": (67e12, 3.35e12, 80, 450e9, "H100 SXM"),
    "h100-pcie": (51e12, 2.0e12, 80, 300e9, "H100 PCIe"),
    "h100-nvl": (60e12, 3.9e12, 94, 300e9, "H100 NVL"),
}

# PCIe Gen5 x16, per direction: the links between cards without peer access
PCIE_BANDWIDTH = 64e9
PCIE_LATENCY = 10e-6

# fractions measured on NVIDIA H100 80GB HBM3 at a 700.00 W power limit by
# chip_smoke.py phase 17 (a) (search_efficiency): an 8192^3 bf16 GEMM in
# 1.3813 ms against the 16-bit peak (an fp32 one, TF32 off, 0.7650 of the
# fp32 rate); z = x + y over 2^28 fp32 in 1.0422 ms against the HBM rate;
# the port's Adam update of 24 x 2^22 fp32 params in 4.3781 ms, counted
# as 7 streams of 4 bytes a param (4 reads, 3 writes), against the HBM
# rate (its foreach passes read and write more than 7)
MEASURED_EFFICIENCY = {
    "h100-sxm": {"matmul_efficiency": 0.8048, "hbm_efficiency": 0.9226,
                 "update_hbm_efficiency": 0.1922},
}


def detect_generation(device_name: str) -> Optional[str]:
    """Normalize ``torch.cuda.get_device_name`` to a GPU_GENERATIONS key
    ('NVIDIA H100 80GB HBM3' -> 'h100-sxm'), or None when unrecognized."""
    name = device_name.lower()
    if "h100" not in name:
        return None
    if "pcie" in name:
        return "h100-pcie"
    if "nvl" in name:
        return "h100-nvl"
    return "h100-sxm"


def _peak_16bit(gen: str) -> float:
    from ..obs.telemetry import PEAK_FLOPS

    return PEAK_FLOPS[GPU_GENERATIONS[gen][4]]


@dataclasses.dataclass
class GPUMachineModel:
    """Analog of MachineModel v0/v1 with GPU parameters (field names as in
    the JAX package's TPUMachineModel)."""

    num_chips: int = 1
    # nodes connected by the network; the cards of a node share NVLink
    num_hosts: int = 1
    # 0 = pods follow ``num_hosts``; >= 2 an explicit pod count, which in
    # this cost model is the network split (``num_hosts`` kept equal)
    num_pods: int = 0
    generation: str = "h100-sxm"
    peak_flops: float = 989e12  # dense 16-bit
    peak_flops_f32: float = 67e12
    hbm_bandwidth: float = 3.35e12  # bytes/s
    hbm_capacity: int = 80 * 1024 ** 3  # bytes
    ici_bandwidth: float = 225e9  # bytes/s per ring direction
    ici_links_per_chip: int = 2
    ici_latency: float = 5e-6  # seconds per ring step
    torus: Tuple[int, ...] = (1,)  # one ring of the node's cards
    dcn_bandwidth: float = 400e9  # bytes/s per node across nodes
    dcn_latency: float = 10e-6
    # measured fractions (MEASURED_EFFICIENCY, the H100 SXM entry)
    matmul_efficiency: float = 0.8048
    hbm_efficiency: float = 0.9226
    update_hbm_efficiency: float = 0.1922
    # FLOP/s of a matmul run in fp32 (the port's alone). 0: every matmul at
    # ``peak_flops`` whatever its dtype, the JAX model's rule (a TPU's
    # matrix unit takes fp32 operands at its 16-bit rate, in bf16 passes).
    # A card's entry sets its fp32 rate: the port runs IEEE fp32 with TF32
    # off, so an fp32 GEMM runs on the CUDA cores, not the tensor cores
    matmul_flops_f32: float = 0.0

    @staticmethod
    def from_generation(gen: str, num_chips: int = 1,
                        torus: Optional[Tuple[int, ...]] = None,
                        num_hosts: int = 1,
                        peer_access: bool = True) -> "GPUMachineModel":
        if gen not in GPU_GENERATIONS:
            raise ValueError(
                f"GPUMachineModel: unknown generation {gen!r}; the port "
                f"knows {sorted(GPU_GENERATIONS)}")
        f32, hbm_bw, hbm_gib, nvlink, _ = GPU_GENERATIONS[gen]
        if torus is None:
            torus = _default_torus(num_chips // max(num_hosts, 1))
        link, lat = (nvlink / 2, 5e-6) if peer_access else \
            (PCIE_BANDWIDTH / 2, PCIE_LATENCY)
        m = GPUMachineModel(
            num_chips=num_chips, num_hosts=num_hosts, generation=gen,
            peak_flops=_peak_16bit(gen), peak_flops_f32=f32,
            hbm_bandwidth=hbm_bw, hbm_capacity=hbm_gib * 1024 ** 3,
            ici_bandwidth=link, ici_links_per_chip=2, ici_latency=lat,
            torus=torus)
        m.matmul_flops_f32 = f32
        for k, v in MEASURED_EFFICIENCY.get(gen, {}).items():
            setattr(m, k, v)
        return m

    @staticmethod
    def from_file(path: str, num_chips: int = 1) -> "GPUMachineModel":
        """v1: ``key = value`` lines, the JAX package's keys
        (flexflow_tpu/search/machine_model.py:101-180). ``generation``
        names a card of GPU_GENERATIONS (default ``h100-sxm``); another
        name raises. ``num_pods`` and ``dcn_bisection_gbps`` are validated
        at parse time with errors naming the field."""
        kv: Dict[str, str] = {}
        with open(path) as f:
            for line in f:
                line = line.split("#")[0].strip()
                if "=" in line:
                    k, v = line.split("=", 1)
                    kv[k.strip()] = v.strip()

        def _bad(field: str, why: str):
            return ValueError(
                f"machine model file {path}: field {field!r} = "
                f"{kv[field]!r} is invalid: {why}")

        num_pods = 0
        if "num_pods" in kv:
            try:
                num_pods = int(kv["num_pods"])
            except ValueError:
                raise _bad("num_pods", "expected an integer pod count")
            if num_pods < 1:
                raise _bad("num_pods", "the machine needs >= 1 pod")
            if num_chips % num_pods:
                raise _bad(
                    "num_pods",
                    f"must divide num_chips={num_chips} — a pod is a "
                    "whole NVLink domain, cards cannot straddle pods")
        num_hosts = int(kv.get("num_hosts", 1))
        if num_pods:
            if "num_hosts" in kv and num_hosts != num_pods:
                raise _bad(
                    "num_pods",
                    f"conflicts with num_hosts={num_hosts}: this cost "
                    "model has ONE network level, so pods ARE the "
                    "network islands — drop one field or make them equal")
            num_hosts = num_pods
        gen = kv.get("generation", "h100-sxm")
        if gen not in GPU_GENERATIONS:
            raise _bad("generation",
                       f"the port knows {sorted(GPU_GENERATIONS)}")
        m = GPUMachineModel.from_generation(gen, num_chips,
                                            num_hosts=num_hosts)
        m.num_pods = num_pods
        if "dcn_bisection_gbps" in kv:
            try:
                gbps = float(kv["dcn_bisection_gbps"])
            except ValueError:
                raise _bad("dcn_bisection_gbps",
                           "expected a number (GB/s per pod across nodes)")
            if gbps <= 0:
                raise _bad("dcn_bisection_gbps",
                           "network bandwidth must be > 0 GB/s")
            m.dcn_bandwidth = gbps * 1e9
        for field in ("peak_flops", "hbm_bandwidth", "ici_bandwidth",
                      "dcn_bandwidth", "ici_latency", "dcn_latency",
                      "matmul_efficiency", "hbm_efficiency",
                      "update_hbm_efficiency", "matmul_flops_f32"):
            if field in kv:
                setattr(m, field, float(kv[field]))
        if "hbm_capacity" in kv:
            m.hbm_capacity = int(float(kv["hbm_capacity"]))
        if "torus" in kv:
            m.torus = tuple(int(x) for x in kv["torus"].split("x"))
        return m

    @staticmethod
    def multipod(generation: str, num_pods: int, chips_per_pod: int,
                 dcn_gbps: float = 0.0) -> "GPUMachineModel":
        """A simulated machine of ``num_pods`` NVLink domains of
        ``chips_per_pod`` cards each, joined by the network (cost model
        only)."""
        if num_pods < 1:
            raise ValueError(f"multipod: num_pods must be >= 1, got "
                             f"{num_pods}")
        if chips_per_pod < 1:
            raise ValueError(f"multipod: chips_per_pod must be >= 1, got "
                             f"{chips_per_pod}")
        m = GPUMachineModel.from_generation(
            generation, num_pods * chips_per_pod, num_hosts=num_pods)
        m.num_pods = num_pods
        if dcn_gbps:
            if dcn_gbps <= 0:
                raise ValueError(
                    f"multipod: dcn_gbps must be > 0, got {dcn_gbps}")
            m.dcn_bandwidth = dcn_gbps * 1e9
        return m

    def apply_pod_overrides(self, num_pods: int = 0,
                            dcn_gbps: float = 0.0) -> "GPUMachineModel":
        """Apply the ``--pods`` / ``--dcn-gbps`` CLI overrides onto a
        constructed machine (unity_search's machine-from-config path)."""
        if num_pods:
            if num_pods < 1:
                raise ValueError(
                    f"--pods must be >= 1, got {num_pods}")
            if self.num_chips % num_pods:
                raise ValueError(
                    f"--pods {num_pods} does not divide the machine's "
                    f"{self.num_chips} chips — a pod is a whole NVLink "
                    "domain, cards cannot straddle pods")
            self.set_num_hosts(num_pods)
            self.num_pods = num_pods
        if dcn_gbps:
            if dcn_gbps <= 0:
                raise ValueError(
                    f"--dcn-gbps must be > 0, got {dcn_gbps}")
            self.dcn_bandwidth = dcn_gbps * 1e9
        return self

    def set_num_hosts(self, num_hosts: int) -> "GPUMachineModel":
        """Re-split the machine into ``num_hosts`` network-connected nodes,
        recomputing the per-node ring."""
        self.num_hosts = max(num_hosts, 1)
        self.torus = _default_torus(self.chips_per_host)
        return self

    @staticmethod
    def detect(num_chips: Optional[int] = None,
               num_hosts: Optional[int] = None,
               device=None) -> "GPUMachineModel":
        """Build from the card: its name (``torch.cuda.get_device_name``),
        HBM capacity (``get_device_properties().total_memory``), the dense
        16-bit peak from ``obs.telemetry.PEAK_FLOPS``, NVLink figures from
        the name, or PCIe figures where the visible cards lack peer access.
        ``device="cpu"`` (the CPU tests) gives the fixed ``h100-sxm`` entry,
        so search decisions there are deterministic. Without a card and
        without ``device="cpu"`` it raises."""
        import torch

        dev = torch.device(device if device is not None else "cuda")
        n = num_chips or (torch.cuda.device_count()
                          if dev.type == "cuda" else 1)
        hosts = num_hosts or 1
        if n % max(hosts, 1) != 0:
            import warnings

            warnings.warn(
                f"GPUMachineModel.detect: num_hosts={hosts} does not divide "
                f"num_chips={n}; falling back to a single-node model",
                stacklevel=2)
            hosts = 1
        if dev.type == "cpu":
            return GPUMachineModel.from_generation("h100-sxm", n,
                                                   num_hosts=hosts)
        if not torch.cuda.is_available():
            raise RuntimeError(
                "GPUMachineModel.detect: no CUDA device; pass device='cpu' "
                "for the fixed H100 SXM entry")
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        name = torch.cuda.get_device_name(idx)
        gen = detect_generation(name)
        if gen is None:
            raise ValueError(
                f"GPUMachineModel.detect: no entry for {name!r}; give "
                "--machine-model-file with its figures")
        visible = torch.cuda.device_count()
        peer = all(torch.cuda.can_device_access_peer(a, b)
                   for a in range(visible) for b in range(visible)
                   if a != b)
        m = GPUMachineModel.from_generation(gen, n, num_hosts=hosts,
                                            peer_access=peer)
        m.hbm_capacity = int(torch.cuda.get_device_properties(
            idx).total_memory)
        return m

    @property
    def chips_per_host(self) -> int:
        return max(self.num_chips // max(self.num_hosts, 1), 1)

    @property
    def pods(self) -> int:
        """Pod count: the explicit ``num_pods`` when set, else the node
        count."""
        return max(self.num_pods or self.num_hosts, 1)

    @property
    def chips_per_pod(self) -> int:
        return max(self.num_chips // self.pods, 1)

    # ---- communication cost primitives (the JAX package's alpha-beta
    # formulas, flexflow_tpu/search/machine_model.py:286-393) ---------------
    # ``medium``: "ici" (inside a node) or "dcn" (across nodes). The
    # network is per node, shared by its participating cards
    # (``nic_sharers``; reference: EnhancedMachineModel's shared NIC
    # channel, simulator.h:311-364).
    def _link(self, medium: str, nic_sharers: int, links: int
              ) -> Tuple[float, float]:
        if medium == "dcn":
            return (self.dcn_bandwidth / max(nic_sharers, 1),
                    self.dcn_latency)
        return (self.ici_bandwidth * links, self.ici_latency)

    def _ici_ring(self, num_participants: int) -> Tuple[int, int]:
        """(usable links, per-round latency hops) for a ring collective over
        ``num_participants`` cards: a group spanning k ring axes runs k
        concurrent bidirectional rings (2k links per card), and the hop
        count is the sum of axis extents."""
        rem = max(num_participants, 1)
        axes = 0
        hops = 0
        for d in self.torus:
            if d <= 1:
                continue
            if rem <= 1 or rem % d:
                break
            axes += 1
            hops += d - 1
            rem //= d
        if rem > 1:
            hops += rem - 1
        links = min(2 * max(axes, 1), self.ici_links_per_chip)
        return links, max(hops, 1)

    def allreduce_time(self, bytes_per_chip: int, num_participants: int,
                       medium: str = "ici", nic_sharers: int = 1) -> float:
        """Ring all-reduce: 2*(n-1)/n * bytes over the per-card link
        bandwidth."""
        if num_participants <= 1 or bytes_per_chip == 0:
            return 0.0
        if medium == "ici":
            links, hops = self._ici_ring(num_participants)
            eff_bw, lat = self._link(medium, nic_sharers, links)
            n = num_participants
            return (lat * 2 * hops
                    + 2 * (n - 1) / n * bytes_per_chip / eff_bw)
        eff_bw, lat = self._link(medium, nic_sharers, 2)
        steps = 2 * (num_participants - 1)
        return (lat * steps
                + steps / num_participants * bytes_per_chip / eff_bw)

    def allgather_time(self, bytes_per_chip: int, num_participants: int,
                       medium: str = "ici", nic_sharers: int = 1) -> float:
        if num_participants <= 1 or bytes_per_chip == 0:
            return 0.0
        if medium == "ici":
            links, hops = self._ici_ring(num_participants)
            eff_bw, lat = self._link(medium, nic_sharers, links)
            n = num_participants
            return (lat * hops
                    + (n - 1) * bytes_per_chip / eff_bw)
        eff_bw, lat = self._link(medium, nic_sharers, 2)
        steps = num_participants - 1
        return (lat * steps
                + steps * bytes_per_chip / eff_bw)

    def alltoall_time(self, bytes_per_chip: int, num_participants: int,
                      medium: str = "ici", nic_sharers: int = 1) -> float:
        if num_participants <= 1 or bytes_per_chip == 0:
            return 0.0
        eff_bw, lat = self._link(medium, nic_sharers,
                                 self.ici_links_per_chip)
        return (lat * (num_participants - 1)
                + bytes_per_chip * (num_participants - 1)
                / num_participants / eff_bw)

    def p2p_time(self, num_bytes: int, medium: str = "ici") -> float:
        if medium == "dcn":
            return self.dcn_latency + num_bytes / self.dcn_bandwidth
        return self.ici_latency + num_bytes / self.ici_bandwidth

    # ---- hierarchical (NVLink inside a node, the network across) ----------
    def hier_allreduce_time(self, bytes_per_chip: int, ici_n: int,
                            dcn_n: int, nic_sharers: int = 1) -> float:
        if dcn_n <= 1:
            return self.allreduce_time(bytes_per_chip, ici_n)
        t = self.allreduce_time(bytes_per_chip, ici_n)
        t += self.allreduce_time(bytes_per_chip // max(ici_n, 1), dcn_n,
                                 medium="dcn", nic_sharers=nic_sharers)
        return t

    def hier_allgather_time(self, bytes_per_chip: int, ici_n: int,
                            dcn_n: int, nic_sharers: int = 1) -> float:
        if dcn_n <= 1:
            return self.allgather_time(bytes_per_chip, ici_n)
        t = self.allgather_time(bytes_per_chip, dcn_n, medium="dcn",
                                nic_sharers=nic_sharers)
        t += self.allgather_time(bytes_per_chip * dcn_n, ici_n)
        return t

    def hier_alltoall_time(self, bytes_per_chip: int, ici_n: int,
                           dcn_n: int, nic_sharers: int = 1) -> float:
        if dcn_n <= 1:
            return self.alltoall_time(bytes_per_chip, ici_n)
        dcn_frac = (dcn_n - 1) / dcn_n
        t = self.alltoall_time(int(bytes_per_chip * dcn_frac) + 1, dcn_n,
                               medium="dcn", nic_sharers=nic_sharers)
        t += self.alltoall_time(bytes_per_chip // max(dcn_n, 1), ici_n)
        return t


def _default_torus(n: int) -> Tuple[int, ...]:
    # a switch joins every card of a node: one ring of all of them
    return (max(n, 1),)
