"""Workload-side bootstrap: the consumer of the injected env.

The operator injects either the ``TPUJOB_*`` variables or the
torch.distributed spelling (``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
``RANK``); ``process_env`` reads both, exactly as the JAX package's
``tpujob/workloads/distributed.py`` does (this is a copy of its
JAX-free part, so the port imports nothing of ``tpujob``).  One
difference, deliberate: under a launcher (``torchrun`` sets
``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``) the launcher's world and rank
win, because its children inherit the pod's ``TPUJOB_*`` values, which
count pods, not processes.

``initialize`` is the port's ``jax.distributed.initialize``: one
``torch.distributed`` process group (NCCL on the card, gloo on the CPU)
for a multi-process job, none for a single process.  The trainers wrap
their model in ``DistributedDataParallel`` when a group exists
(``train_lib.data_parallel``).

The mesh (``AXIS_ORDER``, ``make_mesh``, ``Mesh``): named axes over the
ranks, one process group for each set of axes (an axis alone, or the
replica group of a parameter shard, ``REPLICA_AXES``), and each rank's
share of the batch (``local_batch_slice`` over the data axes) and of the
sequence (``local_seq_slice``); ``TOKEN_AXES`` and ``token_shards`` say
which ranks hold distinct tokens (a tensor group holds the same ones,
and so does an expert group: the batch is not split over ``expert``, as
the JAX package's ``batch_axes`` leaves it out, so every rank of an
expert group routes the same rows to its own experts).  ``expert`` is
neither a token axis nor a replica axis of an FSDP shard: its ranks
hold different experts.  ``Mesh.group("expert", "tensor")`` is the
group a sparse FFN sums its partial outputs over.  Five of the JAX
package's mesh helpers have no body here: under explicit ranks every
activation already lies as batch over the data axes and sequence over
the sequence axis, because each rank feeds and keeps only its own rows
and columns, so
``batch_sharding`` and ``replicated`` (GSPMD placements of whole
arrays), ``constrain_activation`` (a GSPMD layout pin) and
``shard_map`` (a manual region over global arrays) have nothing to
place, and ``devices_have_slice_index`` (a TPU device attribute) has
nothing to probe: a node is a "slice", and the row-major rank layout
keeps every axis but data inside one.

Elastic resize, the workload half of the drain/join protocol
(``WorldSignal``, ``parse_world_signal``, ``plan_resize``, ``shutdown``,
``reinitialize``): the controller publishes the live world on job
annotations, and a process re-rendezvouses at the new size.

The other direction, workload to controller, is the progress heartbeat:
``ProgressReporter`` publishes a ``tpujob.dev/progress`` record (the
port's copy of ``format_progress``, the wire format the controller parses)
on the pod's own annotation, rate-limited, through a small in-cluster
client (``progress_publisher_from_env``: the service account's token and
CA, one merge-patch ``PATCH`` through ``urllib``).
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import json
import logging
import os
import ssl
import time
import urllib.request
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from tpujob_torch import resolve_device

log = logging.getLogger("tpujob_torch.workloads")


@dataclasses.dataclass(frozen=True)
class ProcessEnv:
    """The injected cluster spec, parsed.  ``local_rank`` (the port's own
    field) is this process's index among the processes of its host: the
    launcher's ``LOCAL_RANK``, else 0 (one process a pod)."""

    coordinator_address: Optional[str]
    num_processes: int
    process_id: int
    num_slices: int
    slice_id: int
    devices_per_host: Optional[int]
    global_devices: Optional[int]
    accelerator: Optional[str]
    topology: Optional[str]
    local_rank: int = 0

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1


def _geti(env: Dict[str, str], key: str, default: Optional[int] = None) -> Optional[int]:
    v = env.get(key)
    if v is None or v == "":
        return default
    return int(v)


def under_launcher(env: Dict[str, str]) -> bool:
    """True in a child of a per-host launcher (``torchrun``), which sets
    ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE`` for each process it starts."""
    return bool(env.get("LOCAL_RANK")) and bool(env.get("LOCAL_WORLD_SIZE"))


def process_env(env: Optional[Dict[str, str]] = None) -> ProcessEnv:
    """Parse the env into a ProcessEnv: the one place the rank is derived.

    Under a launcher, its ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and
    ``MASTER_ADDR:MASTER_PORT``.  Otherwise the JAX package's order:
    ``TPUJOB_*`` first, the torch.distributed spelling as fallback, local
    rank 0."""
    e = dict(os.environ) if env is None else env
    coord = e.get("TPUJOB_COORDINATOR_ADDRESS")
    if coord is None and e.get("MASTER_ADDR"):
        coord = f"{e['MASTER_ADDR']}:{e.get('MASTER_PORT', '23456')}"
    num = _geti(e, "TPUJOB_NUM_PROCESSES") or _geti(e, "WORLD_SIZE", 1) or 1
    pid = _geti(e, "TPUJOB_PROCESS_ID")
    if pid is None:
        pid = _geti(e, "RANK", 0) or 0
    local_rank = 0
    if under_launcher(e):
        if e.get("MASTER_ADDR"):
            coord = f"{e['MASTER_ADDR']}:{e.get('MASTER_PORT', '23456')}"
        num = _geti(e, "WORLD_SIZE", 1) or 1
        pid = _geti(e, "RANK", 0) or 0
        local_rank = _geti(e, "LOCAL_RANK", 0) or 0
    return ProcessEnv(
        coordinator_address=coord,
        num_processes=num,
        process_id=pid,
        num_slices=_geti(e, "TPUJOB_NUM_SLICES", 1) or 1,
        slice_id=_geti(e, "TPUJOB_SLICE_ID", 0) or 0,
        devices_per_host=_geti(e, "TPUJOB_DEVICES_PER_HOST"),
        global_devices=_geti(e, "TPUJOB_GLOBAL_DEVICES"),
        accelerator=e.get("TPU_ACCELERATOR_TYPE"),
        topology=e.get("TPU_TOPOLOGY"),
        local_rank=local_rank,
    )


def local_device(name) -> torch.device:
    """``resolve_device(name)`` for this process: in a multi-process job a
    bare ``"cuda"`` is this process's card, ``cuda:<local rank>``
    (``ProcessEnv.local_rank``); an explicit ``cuda:N`` is kept as it
    is."""
    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        pe = process_env()
        if pe.is_distributed:
            dev = resolve_device(f"cuda:{pe.local_rank}")
    return dev


def group_size() -> int:
    """The world of the live process group; 1 when there is none."""
    return tdist.get_world_size() if tdist.is_initialized() else 1


def init_method(address: str) -> str:
    """The rendezvous URL of a coordinator address: ``host:port`` dials
    TCP (rank 0 hosts the store); an address with a scheme
    (``file:///shared/path``, ``tcp://...``) is used as it is."""
    return address if "://" in address else f"tcp://{address}"


# The rendezvous store of each address this process joined a group at,
# kept for the life of the process and used again by every later group
# there.  A re-rendezvous then always meets the same server (rank 0's TCP
# server never goes away between groups).  Otherwise torch hands a new
# rendezvous the old server while anything still holds the old group
# (DDP's hooks on the parameters do), or a new one once nothing does, and
# a peer that dials early reaches the old one: the ranks then rendezvous
# on two servers and hang.
_stores: Dict[str, "tdist.Store"] = {}


def init_group(pe: ProcessEnv, device=None, backend: Optional[str] = None,
               timeout: Optional[datetime.timedelta] = None) -> None:
    """Join ``pe``'s process group, whatever its size: NCCL when
    ``device`` is a CUDA device (made this process's current device), gloo
    otherwise; ``backend`` overrides the choice.  A single process with no
    coordinator rendezvouses on an in-memory store."""
    device = torch.device(device if device is not None else "cpu")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {} if timeout is None else {"timeout": timeout}
    log.info("init_process_group backend=%s coordinator=%s world=%d rank=%d",
             backend, pe.coordinator_address, pe.num_processes,
             pe.process_id)
    if pe.coordinator_address is None:
        if pe.is_distributed:
            raise ValueError(
                f"a {pe.num_processes}-process job needs a coordinator "
                "address (TPUJOB_COORDINATOR_ADDRESS or MASTER_ADDR)")
        tdist.init_process_group(backend, store=tdist.HashStore(),
                                 world_size=1, rank=0, **kw)
        return
    url = init_method(pe.coordinator_address)
    store = _stores.get(url)
    if store is None:
        store, _, _ = next(tdist.rendezvous(url, pe.process_id,
                                            pe.num_processes, **kw))
        _stores[url] = store
    elif timeout is not None:
        store.set_timeout(timeout)
    # Each rendezvous at a world counts its joins on the store and keys its
    # group under the count, so every group starts on keys of its own.
    world = pe.num_processes
    joins = store.add(f"tpujob/joins/{world}", 1)
    tdist.init_process_group(
        backend, store=tdist.PrefixStore(
            f"tpujob/{world}/{(joins - 1) // world}", store),
        world_size=world, rank=pe.process_id, **kw)


def initialize(env: Optional[ProcessEnv] = None, *, device=None,
               backend: Optional[str] = None,
               timeout: Optional[datetime.timedelta] = None) -> ProcessEnv:
    """The port's ``init_process_group`` (the JAX package's ``initialize``).

    A single-process job makes no group.  A multi-process job joins one
    (``init_group``: NCCL for a CUDA ``device``, gloo for the CPU, or
    ``backend``).  Idempotent: with a group already up (a caller that
    brought up its own, or an earlier call) the env is checked against it
    and returned; a group of another world or rank is an error."""
    pe = env or process_env()
    if tdist.is_initialized():
        world, rank = tdist.get_world_size(), tdist.get_rank()
        if (world, rank) != (pe.num_processes, pe.process_id):
            raise RuntimeError(
                f"a process group of world {world} (rank {rank}) is "
                f"already initialized, but the env asks for world "
                f"{pe.num_processes} (rank {pe.process_id})")
        return pe
    if not pe.is_distributed:
        log.info("single-process job; no process group")
        return pe
    init_group(pe, device, backend, timeout)
    return pe


def local_batch_slice(global_batch: int, env: Optional[ProcessEnv] = None,
                      mesh: Optional["Mesh"] = None) -> Tuple[int, int]:
    """(start, size) of this process's rows of the global batch: split
    over the processes, or with ``mesh`` over its batch axes only (the
    ranks of one sequence group feed the same rows)."""
    if mesh is not None:
        axes = batch_axes(mesh)
        shards = batch_divisor(mesh, *axes)
        if global_batch % shards != 0:
            raise ValueError(
                f"global batch {global_batch} not divisible by the "
                f"{shards} batch shards of mesh axes {axes}")
        per = global_batch // shards
        return mesh.flat_index(axes) * per, per
    pe = env or process_env()
    if global_batch % pe.num_processes != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by {pe.num_processes} processes"
        )
    per = global_batch // pe.num_processes
    return pe.process_id * per, per


def local_seq_slice(seq_len: int, mesh: "Mesh") -> Tuple[int, int]:
    """(start, size) of this rank's columns along the ``sequence`` axis
    (the contiguous layout; the whole sequence without one)."""
    n = mesh.size("sequence")
    if seq_len % n != 0:
        raise ValueError(
            f"sequence length {seq_len} not divisible by the sequence axis "
            f"size {n}")
    per = seq_len // n
    return mesh.index("sequence") * per, per


# ---------------------------------------------------------------------------
# the mesh: named axes over the ranks
# ---------------------------------------------------------------------------
#
# The JAX package's mesh places devices; here each rank is one device, and
# a set of axes is a process group (the module docstring says which of its
# helpers have no body here).

# Canonical logical axis order, slowest-varying first (the JAX package's):
# data tolerates the slowest links, so it varies slowest and alone crosses
# nodes; sequence and tensor communicate every layer and vary fastest.
AXIS_ORDER: Tuple[str, ...] = ("data", "fsdp", "expert", "pipeline",
                               "sequence", "tensor")


def _factor_axes(n_devices: int, axes: Dict[str, int]) -> Dict[str, int]:
    """Resolve at most one -1 axis to soak up the remaining devices."""
    sizes = dict(axes)
    wild = [k for k, v in sizes.items() if v == -1]
    if len(wild) > 1:
        raise ValueError(f"at most one axis may be -1, got {wild}")
    fixed = 1
    for k, v in sizes.items():
        if v != -1:
            if v <= 0:
                raise ValueError(f"axis {k!r} must be positive or -1, got {v}")
            fixed *= v
    if wild:
        if n_devices % fixed != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by fixed axes product {fixed}"
            )
        sizes[wild[0]] = n_devices // fixed
        fixed = n_devices
    if fixed != n_devices:
        raise ValueError(
            f"mesh axes {sizes} multiply to {fixed}, but {n_devices} devices present"
        )
    return sizes


def hybrid_mesh_shapes(
    names: Tuple[str, ...], shape: Tuple[int, ...], num_slices: int
) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The split of a multi-node mesh: the slowest axis absorbs the node
    boundary so only it crosses between nodes.  Returns ``(ici_shape,
    dcn_shape)`` (within a node, across nodes) with elementwise ``ici *
    dcn == shape``; raises if the slowest axis cannot be split."""
    if num_slices <= 1:
        raise ValueError(f"hybrid mesh needs num_slices > 1, got {num_slices}")
    first = shape[0]
    if first % num_slices != 0:
        raise ValueError(
            f"multislice mesh: slowest axis {names[0]!r}={first} must be "
            f"divisible by num_slices={num_slices}, or per-layer "
            f"collectives would cross the DCN"
        )
    dcn = [1] * len(shape)
    dcn[0] = num_slices
    ici = list(shape)
    ici[0] = first // num_slices
    return tuple(ici), tuple(dcn)


def mesh_shape(axes: Optional[Dict[str, int]], world: int
               ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """The axis names (in ``AXIS_ORDER``, any others after them, sorted)
    and sizes of a mesh of ``world`` ranks (``axes`` as ``make_mesh``
    takes them)."""
    sizes = _factor_axes(world, dict(axes or {"data": -1}))
    names = [a for a in AXIS_ORDER if a in sizes]
    names += sorted(a for a in sizes if a not in AXIS_ORDER)
    return tuple(names), tuple(sizes[a] for a in names)


@dataclasses.dataclass
class Mesh:
    """Named axes over the ranks of the job, laid out row-major (data
    slowest): rank ``r`` sits at ``np.unravel_index(r, shape)``.  ``groups``
    holds, for each set of axes longer than 1 (a tuple in the mesh's
    order), the process group of the ranks that differ from this one along
    those axes only (none without a process group, at world 1)."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int = 0
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict)

    @property
    def coords(self) -> Tuple[int, ...]:
        return tuple(int(i) for i in np.unravel_index(self.rank, self.shape))

    def size(self, *axes: str) -> int:
        """The axes' lengths multiplied; 1 for an axis the mesh does not
        carry."""
        out = 1
        for a in axes:
            if a in self.axis_names:
                out *= self.shape[self.axis_names.index(a)]
        return out

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 off the mesh)."""
        return (self.coords[self.axis_names.index(axis)]
                if axis in self.axis_names else 0)

    def flat_index(self, axes: Tuple[str, ...]) -> int:
        """This rank's row-major index over ``axes`` together."""
        out = 0
        for a in axes:
            out = out * self.size(a) + self.index(a)
        return out

    def live(self, axes) -> Tuple[str, ...]:
        """``axes`` the mesh carries longer than 1, in the mesh's order."""
        return tuple(a for a in self.axis_names
                     if a in axes and self.size(a) > 1)

    def grid(self, *axes: str, rank: Optional[int] = None) -> np.ndarray:
        """The ranks that differ from ``rank`` (default this one) along
        ``axes`` only, as an array of one dim an axis in the order given
        (an axis the mesh does not carry is 1 long)."""
        coords = list(np.unravel_index(self.rank if rank is None else rank,
                                       self.shape))
        out = np.empty([self.size(a) for a in axes], dtype=np.int64)
        for at in np.ndindex(out.shape):
            for a, j in zip(axes, at):
                if a in self.axis_names:
                    coords[self.axis_names.index(a)] = j
            out[at] = np.ravel_multi_index(coords, self.shape)
        return out

    def axis_ranks(self, axis: str, rank: Optional[int] = None) -> List[int]:
        """The ranks that differ from ``rank`` (default this one) along
        ``axis`` only, in the axis' order."""
        return self.grid(axis, rank=rank).tolist()

    def group(self, *axes: str):
        """The process group of the ranks that differ from this one along
        ``axes`` only (row-major over them): None when they are all 1
        long (no exchange needed)."""
        return self.groups.get(self.live(axes))


def make_mesh(axes: Optional[Dict[str, int]] = None, *,
              env: Optional[ProcessEnv] = None) -> Mesh:
    """The mesh of this job's ranks (``axes`` maps axis name -> size, one
    ``-1`` wildcard; default ``{"data": -1}``, pure data parallelism).

    The world and this rank come from the live process group, or from
    ``env`` without one.  Every process must call this together: the
    process groups of every set of axes longer than 1 (each axis alone,
    and e.g. the replica group, data x sequence, that holds one shard of a
    parameter) are made with ``new_group`` on every rank, in one order.
    A multi-node job (``num_slices`` > 1) must be able to split its data
    axis over the nodes (``hybrid_mesh_shapes``); the row-major layout
    then puts each node's ranks on one stretch of the data axis."""
    pe = env or process_env()
    world = group_size() if tdist.is_initialized() else pe.num_processes
    rank = tdist.get_rank() if tdist.is_initialized() else pe.process_id
    names, shape = mesh_shape(axes, world)
    if pe.num_slices > 1 and world % pe.num_slices == 0:
        hybrid_mesh_shapes(names, shape, pe.num_slices)
    mesh = Mesh(names, shape, rank)
    if world > 1:
        if not tdist.is_initialized():
            raise RuntimeError(
                f"a mesh of {world} ranks needs the process group "
                "(distributed.initialize) first")
        live = mesh.live(names)
        for k in range(1, len(live) + 1):
            for subset in itertools.combinations(live, k):
                seen = set()
                for r in range(world):  # every group, in one order, everywhere
                    ranks = tuple(mesh.grid(*subset, rank=r).ravel().tolist())
                    if ranks in seen:
                        continue
                    seen.add(ranks)
                    g = tdist.new_group(list(ranks))
                    if rank in ranks:
                        mesh.groups[subset] = g
    return mesh


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """The batch-parallel axes this mesh carries: data and fsdp split the
    batch; every model axis replicates it."""
    return tuple(a for a in ("data", "fsdp") if a in mesh.axis_names)


def batch_divisor(mesh: Mesh, *axes: str) -> int:
    """Global batch dim 0 must be a multiple of this (the number of batch
    shards the mesh produces)."""
    return mesh.size(*(axes or batch_axes(mesh)))


# The axes whose ranks hold distinct tokens: rows over data and fsdp,
# columns over sequence.  The ranks of a model axis (tensor, expert) hold
# the same tokens, so a sum over the batch runs over these axes, and the
# gradient of a parameter shard is averaged over them.
TOKEN_AXES: Tuple[str, ...] = ("data", "fsdp", "sequence")
# The ranks that hold the same shard of a parameter: the token axes but
# fsdp, which shards it (ZeRO-3).  Not expert: its ranks hold different
# experts, and the same replicated parameters with the same gradients.
REPLICA_AXES: Tuple[str, ...] = ("data", "sequence")


def token_group(mesh: Optional[Mesh] = None):
    """The process group of the ranks that hold distinct tokens: the token
    axes' group, or the whole world without a mesh; None when this rank
    is the only one."""
    if mesh is not None:
        return mesh.group(*TOKEN_AXES)
    return tdist.group.WORLD if group_size() > 1 else None


def token_shards(mesh: Optional[Mesh] = None) -> int:
    """How many distinct shards of the global batch's tokens the ranks
    hold: the token axes' sizes multiplied, or the world without a
    mesh."""
    return group_size() if mesh is None else mesh.size(*TOKEN_AXES)


# ---------------------------------------------------------------------------
# elastic resize: the workload half of the drain/join protocol
# ---------------------------------------------------------------------------
#
# The controller publishes the LIVE world size on job annotations (pod env
# is bootstrap-only): a pending shrink publishes `target-world-size` first
# so every process can hit a checkpoint barrier, and the committed world
# arrives as `world-size` + a bumped `resize-generation` once the join /
# drain staging completed.  A real pod reads the annotations through a
# downward-API file mount (one `key="escaped value"` line per annotation).

# the annotation keys (``tpujob.api.constants``), the port's own copies
ANNOTATION_WORLD_SIZE = "tpujob.dev/world-size"
ANNOTATION_TARGET_WORLD_SIZE = "tpujob.dev/target-world-size"
ANNOTATION_RESIZE_GENERATION = "tpujob.dev/resize-generation"

# env var naming the downward-API file carrying the job annotations;
# absent = not elastic
RESIZE_SIGNAL_ENV = "TPUJOB_RESIZE_SIGNAL_FILE"

# resize plan actions (plan_resize return values)
PLAN_CHECKPOINT = "checkpoint"  # drain pending: checkpoint NOW and ack
PLAN_LEAVE = "leave"  # beyond the target: checkpoint, then idle until deleted
PLAN_REJOIN = "rejoin"  # world republished: reinitialize at the new size
# and restore from the latest checkpoint


@dataclasses.dataclass(frozen=True)
class WorldSignal:
    """The published elastic state, parsed from the job annotations."""

    world_size: int  # committed world (every live replica rendezvouses here)
    target_world_size: Optional[int]  # pending drain target (None = steady)
    resize_generation: int  # bumps on every completed resize

    @property
    def drain_pending(self) -> bool:
        return (self.target_world_size is not None
                and self.target_world_size != self.world_size)


def parse_world_signal(annotations: Dict[str, str],
                       default_world: int) -> WorldSignal:
    """A :class:`WorldSignal` from job annotations.  ``default_world`` is
    the bootstrap world (the injected process count): the committed world
    before the controller ever published one.  A value that is not an
    integer counts as absent."""

    def _geti_ann(key):
        v = annotations.get(key)
        if v is None or v == "":
            return None
        try:
            return int(v)
        except ValueError:
            return None

    world = _geti_ann(ANNOTATION_WORLD_SIZE)
    return WorldSignal(
        world_size=world if world is not None else default_world,
        target_world_size=_geti_ann(ANNOTATION_TARGET_WORLD_SIZE),
        resize_generation=_geti_ann(ANNOTATION_RESIZE_GENERATION) or 0,
    )


def parse_downward_annotations(text: str) -> Dict[str, str]:
    """The downward-API ``metadata.annotations`` file format: one
    ``key="escaped value"`` line per annotation (Go strconv.Quote)."""
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or "=" not in line:
            continue
        key, _, raw = line.partition("=")
        raw = raw.strip()
        if raw.startswith('"') and raw.endswith('"') and len(raw) >= 2:
            raw = raw[1:-1].encode().decode("unicode_escape")
        out[key.strip()] = raw
    return out


def read_world_signal(path: Optional[str] = None,
                      default_world: Optional[int] = None) -> Optional[WorldSignal]:
    """The elastic signal from the downward-API annotations file ``path``
    (default: ``$TPUJOB_RESIZE_SIGNAL_FILE``); None when the job is not
    elastic (no file configured or present)."""
    path = path if path is not None else os.environ.get(RESIZE_SIGNAL_ENV)
    if not path:
        return None
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return None
    if default_world is None:
        default_world = process_env().num_processes
    return parse_world_signal(parse_downward_annotations(text), default_world)


def plan_resize(pe: ProcessEnv, signal: Optional[WorldSignal]) -> Optional[str]:
    """What this process must do about the published elastic state:

    - ``None``: steady state, keep training;
    - :data:`PLAN_CHECKPOINT`: a drain is pending; checkpoint now, ack the
      target and pause stepping until the world republishes;
    - :data:`PLAN_LEAVE`: this process is beyond the target; checkpoint,
      then idle until deleted;
    - :data:`PLAN_REJOIN`: the world republished at a size this process
      is not initialized for; :func:`reinitialize` and restore the latest
      checkpoint.
    """
    if signal is None:
        return None
    if signal.drain_pending:
        if pe.process_id >= signal.target_world_size:
            return PLAN_LEAVE
        return PLAN_CHECKPOINT
    if signal.world_size != pe.num_processes:
        if pe.process_id >= signal.world_size:
            # beyond the committed world with no drain pending: a joiner
            # waiting for the republish, or a drained process awaiting
            # deletion; neither has a seat to rejoin
            return None
        return PLAN_REJOIN
    return None


def shutdown() -> None:
    """Destroy the process group (a no-op without one): the first half of
    a re-rendezvous."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def reinitialize(pe: ProcessEnv, num_processes: int,
                 process_id: Optional[int] = None, *, device=None,
                 timeout: Optional[datetime.timedelta] = None) -> ProcessEnv:
    """Re-rendezvous at a new world size: ``shutdown``, then ``initialize``
    with ``num_processes`` at the same coordinator (on ``device``'s
    backend, as ``initialize`` picks it).  Process ids are
    stable under the drain/join protocol (a shrink drains the highest
    ids), so the default keeps this process's id.  Tensors survive, but
    optimizer steps taken since the last checkpoint differ between the
    ranks that stay: restore the latest checkpoint after this returns."""
    new = dataclasses.replace(
        pe, num_processes=num_processes,
        process_id=process_id if process_id is not None else pe.process_id)
    if new.process_id >= new.num_processes:
        # refused BEFORE the teardown: a drained process that gets here by
        # mistake keeps its live group while it waits to be deleted
        raise ValueError(
            f"process {new.process_id} is beyond the new world "
            f"{new.num_processes}: a drained process must exit, not rejoin")
    shutdown()
    return initialize(new, device=device, timeout=timeout)


# ---------------------------------------------------------------------------
# progress heartbeats: the workload -> controller telemetry channel
# ---------------------------------------------------------------------------

# the annotation the controller reads (``tpujob.api.constants``)
ANNOTATION_PROGRESS = "tpujob.dev/progress"
# the pod's own identity, injected by the operator; absent = not running
# under it, and the reporter stays disabled
POD_NAME_ENV = "TPUJOB_POD_NAME"
POD_NAMESPACE_ENV = "TPUJOB_POD_NAMESPACE"
# where the kubelet mounts the pod's service account
SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


def format_progress(step: int, samples_per_sec: Optional[float] = None,
                    checkpoint_step: Optional[int] = None,
                    resize_generation: int = 0,
                    published_at: Optional[float] = None) -> str:
    """One heartbeat value, ``step=1200 sps=3411.5 ckpt=1100 gen=2
    t=1722772000.123`` (every field but ``step`` optional): the wire format
    of ``tpujob/api/progress.py``, which the controller parses."""
    parts = [f"step={int(step)}"]
    if samples_per_sec is not None:
        parts.append(f"sps={float(samples_per_sec):.6g}")
    if checkpoint_step is not None:
        parts.append(f"ckpt={int(checkpoint_step)}")
    if resize_generation:
        parts.append(f"gen={int(resize_generation)}")
    if published_at is not None:
        parts.append(f"t={float(published_at):.3f}")
    return " ".join(parts)


class ProgressReporter:
    """Rate-limited publisher of the progress heartbeat.

    ``publish(value)`` ships one annotation value and may raise; a failure
    is logged (at most once a minute) and dropped, because telemetry must
    never stop training.  ``interval_s`` bounds the publish rate: a 10 ms
    step loop heartbeats every few seconds, not every step."""

    def __init__(self, publish: Optional[Callable[[str], None]],
                 interval_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.publish = publish
        self.interval_s = interval_s
        self._clock = clock
        self._last_pub: Optional[float] = None
        self._last_warn: Optional[float] = None
        self.published = 0  # successful publishes

    @property
    def enabled(self) -> bool:
        return self.publish is not None

    def report(self, step: int, samples_per_sec: Optional[float] = None,
               checkpoint_step: Optional[int] = None,
               resize_generation: int = 0, force: bool = False) -> bool:
        """Publish one heartbeat unless rate-limited; True when it shipped.
        ``force`` bypasses the interval (checkpoint saves, loop exit)."""
        if self.publish is None:
            return False
        now = self._clock()
        if (not force and self._last_pub is not None
                and now - self._last_pub < self.interval_s):
            return False
        value = format_progress(
            step, samples_per_sec=samples_per_sec,
            checkpoint_step=checkpoint_step,
            resize_generation=resize_generation, published_at=time.time())
        # stamped before the attempt: a failing transport must not turn
        # every step into a publish attempt
        self._last_pub = now
        try:
            self.publish(value)
        except Exception as e:  # noqa: TPL005 - telemetry is best-effort;
            # a dead transport must not kill training (warned, rate-limited)
            if self._last_warn is None or now - self._last_warn >= 60.0:
                self._last_warn = now
                log.warning("progress heartbeat publish failed: %s", e)
            return False
        self.published += 1
        return True


def pod_progress_patch(value: str) -> Dict[str, Dict[str, Dict[str, str]]]:
    """The merge-patch body of one heartbeat: only this annotation key, so
    it composes with every other writer of the pod's metadata."""
    return {"metadata": {"annotations": {ANNOTATION_PROGRESS: value}}}


PUBLISH_TIMEOUT_S = 5.0  # the longest one heartbeat may hold up the step loop


def pod_patch_publisher(base_url: str, namespace: str, pod: str, *,
                        token_file: Optional[str] = None,
                        context: Optional[ssl.SSLContext] = None
                        ) -> Callable[[str], None]:
    """``publish(value)``: one ``PATCH`` of the pod with
    ``application/merge-patch+json`` at ``base_url`` (the API server).  The
    bearer token is read from ``token_file`` at every publish (the kubelet
    rotates it); a non-2xx answer raises ``urllib.error.HTTPError``.  The
    API server is reached directly, never through a proxy from the env."""
    url = f"{base_url}/api/v1/namespaces/{namespace}/pods/{pod}"
    opener = urllib.request.build_opener(
        urllib.request.ProxyHandler({}),
        urllib.request.HTTPSHandler(context=context))

    def publish(value: str) -> None:
        req = urllib.request.Request(
            url, method="PATCH",
            data=json.dumps(pod_progress_patch(value)).encode(),
            headers={"Content-Type": "application/merge-patch+json",
                     "Accept": "application/json"})
        if token_file:
            with open(token_file) as f:
                req.add_header("Authorization", f"Bearer {f.read().strip()}")
        with opener.open(req, timeout=PUBLISH_TIMEOUT_S) as resp:
            resp.read()

    return publish


def progress_publisher_from_env(env: Optional[Dict[str, str]] = None,
                                sa_dir: str = SERVICE_ACCOUNT_DIR
                                ) -> Optional[Callable[[str], None]]:
    """The in-cluster publisher: the pod patches its own annotation through
    the API server at ``KUBERNETES_SERVICE_HOST``/``_PORT``, with the
    service account's token and CA under ``sa_dir``.  None (telemetry off)
    without the pod identity (``TPUJOB_POD_NAME``, ``_NAMESPACE``) or
    without that cluster config: a local run, a dryrun, a test."""
    e = dict(os.environ) if env is None else env
    pod = e.get(POD_NAME_ENV)
    if not pod:
        return None
    namespace = e.get(POD_NAMESPACE_ENV) or "default"
    host = e.get("KUBERNETES_SERVICE_HOST")
    port = e.get("KUBERNETES_SERVICE_PORT") or "443"
    token_file = os.path.join(sa_dir, "token")
    ca_file = os.path.join(sa_dir, "ca.crt")
    if not host or not os.path.exists(token_file):
        log.info("progress heartbeats disabled (no in-cluster config)")
        return None
    try:
        context = ssl.create_default_context(
            cafile=ca_file if os.path.exists(ca_file) else None)
    except (OSError, ssl.SSLError) as e_ca:
        log.info("progress heartbeats disabled (unreadable CA %s): %s",
                 ca_file, e_ca)
        return None
    if ":" in host:  # an IPv6 address
        host = f"[{host}]"
    return pod_patch_publisher(f"https://{host}:{port}", namespace, pod,
                               token_file=token_file, context=context)


# ---------------------------------------------------------------------------
# local spawns: a job's ranks as processes of this host (the dryrun, the
# DP-scaling bench)
# ---------------------------------------------------------------------------


def free_port() -> int:
    """A localhost TCP port nothing listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_envs(world: int, port: int) -> List[Dict[str, str]]:
    """Each rank's env on one host, as the operator writes it for a job
    with no ``tpu`` field: the ``TPUJOB_*`` variables and the
    torch.distributed spelling, one coordinator at ``127.0.0.1:port``."""
    return [{"TPUJOB_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
             "TPUJOB_NUM_PROCESSES": str(world),
             "TPUJOB_PROCESS_ID": str(rank), "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port), "WORLD_SIZE": str(world),
             "RANK": str(rank)} for rank in range(world)]


def _spawned(rank, fn, envs, args, out_dir, threads):
    os.environ.update(envs[rank])
    torch.set_num_threads(threads)
    if rank:
        import sys

        sys.stdout = open(os.devnull, "w")
    result = fn(rank, *args)
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn_local(fn: Callable, world: int, *args, timeout_s: float) -> list:
    """``fn(rank, *args)`` in ``world`` new processes (start method
    ``spawn``, so ``fn`` is a module-level function) with ``local_envs``'
    env, the host's cores shared out among them, only rank 0's standard
    output kept.  Their results in rank order.  A rank that raises or dies
    takes the others down and raises here with its traceback; a spawn
    that outlives ``timeout_s`` is killed and raises; no process outlives
    the call."""
    import shutil
    import tempfile

    import torch.multiprocessing as tmp

    envs = local_envs(world, free_port())
    threads = max(1, (os.cpu_count() or 1) // world)
    out_dir = tempfile.mkdtemp(prefix="tpujob_spawn_")
    try:
        ctx = tmp.start_processes(
            _spawned, args=(fn, envs, args, out_dir, threads),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise RuntimeError(f"{world} spawned ranks outlived "
                                       f"{timeout_s} s")
        except (tmp.ProcessRaisedException, tmp.ProcessExitedException) as e:
            raise RuntimeError(f"a spawned rank failed:\n{e}") from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(10)
        return [torch.load(os.path.join(out_dir, f"rank{rank}.pt"),
                           weights_only=False) for rank in range(world)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
