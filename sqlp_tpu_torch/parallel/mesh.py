"""Device meshes over ranks, the state's sharding, and the step's combines.

Port of record: ``sqlp_tpu/parallel/mesh.py:33-161``. The SD step's two
growing axes are sharded, as in the reference:

  * the scenario stores ``scen_deltas [E, S, R]`` / ``scen_weights
    [E, S]`` over S (the mesh's scenario axis);
  * with ``shard_duals`` (always on a 2-D mesh) the dual-vertex pool
    ``duals`` / ``duals_rounded [D, m2]`` / ``duals_score [D]`` over D
    (the dual axis of a 2-D mesh, else the same 1-D axis);
  * Monte-Carlo panels over their rows, across every rank;

and everything else is replicated. One rank is one process
(``parallel.distributed``); a mesh holds one ``torch.distributed`` group
per axis, over the ranks that share the other coordinate. The reference
writes the step in global view and lets XLA insert the collectives; here
each one is explicit, at the place it is needed, built from three
collectives that NCCL and Gloo both implement for CUDA tensors:
``all_reduce`` (MAX, MIN), ``all_gather`` into a list, ``broadcast``.
Sums over ranks are all-gathers added in rank order (:func:`psum`), so
every rank gets the same bits and a seeded run repeats itself.

:func:`local_shard` is the layout with no process group: the block of a
global array that the rank at ``coords`` holds, the block JAX places on
the device at those mesh coordinates.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from sqlp_tpu_torch.parallel import distributed

SCENARIO_AXIS = "scenarios"
DUAL_AXIS = "duals"

# one entry per array dimension: None (not sharded) or the name of the
# mesh axis it shards over
Spec = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's
    coordinate on it, and the group of the ranks along it (None when the
    axis has one rank)."""

    name: Union[str, Tuple[str, ...]]
    size: int
    index: int
    group: object = None


class Mesh:
    """A mesh over the world's ranks, in row order (rank = linear index of
    its coordinates, the first axis major: the device order of
    ``jax.devices()`` in ``sqlp_tpu.parallel.mesh.make_mesh_2d``)."""

    def __init__(self, shape: Dict[str, int], shard_duals: bool):
        if not dist.is_initialized():
            raise RuntimeError("a mesh needs torch.distributed: call "
                               "parallel.distributed.init_distributed first")
        size = math.prod(shape.values())
        world = dist.get_world_size()
        if size != world:
            raise ValueError(f"a mesh of shape {tuple(shape.values())} "
                             f"needs {size} ranks, the group has {world} "
                             f"(one rank per process)")
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = size
        self.rank = dist.get_rank()
        self.coords = {k: int(v) for k, v in zip(
            self.axis_names, np.unravel_index(self.rank,
                                              tuple(shape.values())))}
        self.shard_duals = shard_duals
        backend = distributed.backend()
        timeout = distributed.group_timeout()

        def new_group(ranks):
            # every rank creates every group, in the same order
            return dist.new_group(ranks, backend=backend, timeout=timeout)

        self._axes = {}
        grid = np.arange(size).reshape(tuple(shape.values()))
        world_group = new_group(list(range(size))) if size > 1 else None
        self.world = Axis(self.axis_names, size, self.rank, world_group)
        for a, name in enumerate(self.axis_names):
            n = shape[name]
            group = None
            if n > 1:
                if n == size:
                    group = world_group
                else:
                    # the lines of the grid along axis a
                    lines = np.moveaxis(grid, a, -1).reshape(-1, n)
                    for line in lines:
                        g = new_group([int(r) for r in line])
                        if self.rank in line:
                            group = g
            self._axes[name] = Axis(name, n, self.coords[name], group)
        if len(self.axis_names) == 2:
            self.dual_name, self.scen_name = self.axis_names
        else:
            self.scen_name = self.axis_names[0]
            self.dual_name = self.scen_name if shard_duals else None

    def axis(self, name: str) -> Axis:
        return self._axes[name]

    @property
    def scen_axis(self) -> Axis:
        return self._axes[self.scen_name]

    @property
    def dual_axis(self) -> Optional[Axis]:
        """The axis the dual pool shards over; None when it is
        replicated."""
        return None if self.dual_name is None else self._axes[self.dual_name]

    def specs(self) -> Dict[str, Spec]:
        return state_pspecs(self.scen_name, self.dual_name is not None,
                            self.dual_name)

    def __str__(self) -> str:
        dims = "x".join(str(n) for n in self.shape.values())
        names = " x ".join(self.axis_names)
        tail = "; dual pool sharded too" if (
            self.shard_duals and len(self.axis_names) == 1) else ""
        return f"{dims} ({names}{tail})"


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = SCENARIO_AXIS,
              shard_duals: bool = False) -> Mesh:
    """1-D mesh over the world's ranks (``n_devices``, default all, must
    be the world size: one rank per process). ``shard_duals`` shards the
    dual pool over the same axis as the scenario stores."""
    n = distributed.world_size() if n_devices is None else n_devices
    return Mesh({axis_name: n}, shard_duals)


def make_mesh_2d(n_duals: int, n_scenarios: int,
                 dual_axis: str = DUAL_AXIS,
                 scenario_axis: str = SCENARIO_AXIS) -> Mesh:
    """2-D (duals x scenarios) mesh: the dual pool shards over the first
    axis, the scenario stores over the second."""
    return Mesh({dual_axis: n_duals, scenario_axis: n_scenarios}, True)


def state_pspecs(axis_name: str = SCENARIO_AXIS, shard_duals: bool = False,
                 dual_axis: Optional[str] = None) -> Dict[str, Spec]:
    """Which dimension of which ``SDState`` field shards over which mesh
    axis (the field-name dictionary of the reference,
    ``sqlp_tpu/parallel/mesh.py:60-95``; ``key`` has no counterpart in the
    port's state and stays for the checkpoint's schema). The pool shards
    over ``dual_axis`` when given, else over ``axis_name``."""
    da = dual_axis if dual_axis is not None else axis_name
    s = (None, axis_name)            # [E, S]
    s3 = (None, axis_name, None)     # [E, S, R]
    d = (da, None) if shard_duals else ()    # [D, m2]
    d1 = (da,) if shard_duals else ()        # [D]
    r = ()
    return dict(
        key=r, it=r,
        scen_deltas=s3, scen_weights=s, n_scen=r, n_stream=r,
        total_weight=r, scen_dropped=r,
        duals=d, duals_rounded=d, n_duals=r, duals_dropped=r,
        duals_score=d1,
        cut_alpha=r, cut_beta=r, cut_mark=r, cut_live=r, cut_dual=r,
        cut_x=r,
        inc_alpha=r, inc_beta=r, inc_valid=r,
        x_candidate=r, x_incumbent=r,
        cand_est=r, inc_est=r, req_improvement=r, is_improved=r,
        quad_scalar=r, normDk_1=r, normDk_init=r, xover_dry=r,
        master_solved=r, master_z=r, master_mu=r, master_rho=r,
        sub_warm_Y=r, sub_warm_L=r,
    )


def local_shard(array, spec: Spec, mesh_shape: Dict[str, int],
                coords: Dict[str, int]):
    """The block of ``array`` (numpy or torch) that the rank at mesh
    coordinates ``coords`` holds under ``spec``: each sharded dimension is
    cut into equal contiguous blocks, one per position along its axis."""
    index = []
    for dim, name in enumerate(spec):
        if name is None:
            index.append(slice(None))
            continue
        n, length = mesh_shape[name], array.shape[dim]
        if length % n:
            raise ValueError(f"dimension {dim} of length {length} does not "
                             f"divide over the {n} ranks of {name}")
        block = length // n
        index.append(slice(coords[name] * block, (coords[name] + 1) * block))
    return array[tuple(index)]


# --------------------------------------------------------------- collectives

def all_gather(t: torch.Tensor, axis: Optional[Axis]) -> List[torch.Tensor]:
    """This rank's ``t`` and its peers' along ``axis``, in axis order."""
    if axis is None or axis.size == 1:
        return [t]
    # bool travels as uint8 (Gloo's collectives take no bool tensors)
    flag = t.dtype == torch.bool
    t = (t.to(torch.uint8) if flag else t).contiguous()
    parts = [torch.empty_like(t) for _ in range(axis.size)]
    dist.all_gather(parts, t, group=axis.group)
    return [p.to(torch.bool) for p in parts] if flag else parts


def gather(t: torch.Tensor, axis: Optional[Axis], dim: int = 0
           ) -> torch.Tensor:
    """The blocks along ``axis`` concatenated in axis order on ``dim``."""
    parts = all_gather(t, axis)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def psum(t: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Sum over the ranks along ``axis``, added in axis order (the same
    bits on every rank, run after run)."""
    parts = all_gather(t, axis)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _all_reduce(t: torch.Tensor, axis: Optional[Axis], op) -> torch.Tensor:
    if axis is None or axis.size == 1:
        return t
    t = t.clone()
    dist.all_reduce(t, op=op, group=axis.group)
    return t


def _global_index(offset, n: int, device) -> torch.Tensor:
    if torch.is_tensor(offset):
        return offset.to(device=device, dtype=torch.int64)
    return offset + torch.arange(n, device=device)


def global_quantized_argmax(scores_local: torch.Tensor, axis: Optional[Axis],
                            offset, eps: Optional[float] = None
                            ) -> torch.Tensor:
    """``sd/cuts.py:quantized_argmax`` over a [D, N] panel whose rows are
    sharded along ``axis``: this rank holds rows ``offset + arange(D_local)``
    (or the global indices ``offset`` as a tensor). The quantum comes from
    the global column max, so every rank floors exactly as one device
    would; the winner is the largest floored value, ties to the lowest
    global index. Returns the global row index of each column's winner."""
    if eps is None:
        eps = 1e-4 if scores_local.dtype == torch.float32 else 1e-9
    index = _global_index(offset, scores_local.shape[0],
                          scores_local.device)
    best = _all_reduce(torch.amax(scores_local, dim=0), axis,
                       dist.ReduceOp.MAX)
    quantum = torch.where(torch.isfinite(best), eps * (1.0 + torch.abs(best)),
                          torch.ones_like(best))
    q = torch.floor(scores_local / quantum)
    li = torch.argmax(q, dim=0)
    lv = torch.gather(q, 0, li[None, :])[0]
    gv = _all_reduce(lv, axis, dist.ReduceOp.MAX)
    big = torch.iinfo(torch.int64).max
    cand = torch.where(lv == gv, index[li], torch.full_like(li, big))
    return _all_reduce(cand, axis, dist.ReduceOp.MIN)


def global_argmin_lowest(values_local: torch.Tensor, axis: Optional[Axis],
                         offset: int, carry: Optional[torch.Tensor] = None):
    """``torch.argmin`` over a vector sharded along ``axis`` (this rank
    holds entries ``offset + arange(n_local)``): the global index of the
    smallest value, ties to the lowest index. One all-gather; ``carry``
    (a [k] float64 tensor of this rank's other facts) travels in it, and
    then (index, [axis size, k] carried facts in axis order) is
    returned."""
    li = torch.argmin(values_local)
    facts = torch.stack([values_local[li].to(torch.float64),
                         (offset + li).to(torch.float64)])
    if carry is not None:
        facts = torch.cat([facts, carry])
    got = torch.stack(all_gather(facts, axis))
    values, index = got[:, 0], got[:, 1].to(torch.int64)
    big = torch.full_like(index, torch.iinfo(torch.int64).max)
    idx = torch.min(torch.where(values == torch.min(values), index, big))
    return idx if carry is None else (idx, got[:, 2:])


def gather_rows(local_rows: torch.Tensor, global_idx: torch.Tensor,
                axis: Optional[Axis], offset: int) -> torch.Tensor:
    """Rows ``global_idx`` of a [D, ...] array sharded along ``axis``
    (this rank holds rows ``offset + arange(D_local)``). Every rank along
    the axis must ask for the same indices. The owner contributes each
    row and the others zeros, so the sum is exact. An index no rank owns
    gives a zero row."""
    n = local_rows.shape[0]
    own = (global_idx >= offset) & (global_idx < offset + n)
    rows = local_rows[torch.clamp(global_idx - offset, 0, n - 1)]
    shape = own.shape + (1,) * (rows.dim() - own.dim())
    rows = torch.where(own.reshape(shape), rows, torch.zeros_like(rows))
    return psum(rows, axis)


def broadcast(t: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """The tensor of the first rank along ``axis``, on every rank."""
    if axis is None or axis.size == 1:
        return t
    flag = t.dtype == torch.bool
    t = (t.to(torch.uint8) if flag else t).contiguous().clone()
    dist.broadcast(t, src=dist.get_global_rank(axis.group, 0),
                   group=axis.group)
    return t.to(torch.bool) if flag else t


# ------------------------------------------------------ state and panels

def _field_axes(spec: Spec) -> List[Tuple[int, str]]:
    return [(dim, name) for dim, name in enumerate(spec) if name is not None]


def shard_state(state, mesh: Mesh):
    """This rank's part of a global ``SDState``: each sharded field's
    block (``local_shard``), and each replicated field as rank 0 holds it
    (every rank built the same state; the broadcast makes the bits
    equal)."""
    specs = mesh.specs()
    kw = {}
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        spec = specs[f.name]
        if _field_axes(spec):
            kw[f.name] = local_shard(t, spec, mesh.shape,
                                     mesh.coords).clone()
        else:
            kw[f.name] = replicate(t, mesh)
    return dataclasses.replace(state, **kw)


def gather_state(state, mesh: Mesh):
    """The global ``SDState`` on every rank: each sharded field gathered
    along its axes (a collective: every rank calls it)."""
    specs = mesh.specs()
    kw = {}
    for f in dataclasses.fields(state):
        t = getattr(state, f.name)
        for dim, name in _field_axes(specs[f.name]):
            t = gather(t, mesh.axis(name), dim)
        kw[f.name] = t
    return dataclasses.replace(state, **kw)


def replicate(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's value of a tensor, on every rank."""
    return broadcast(t, mesh.world)


def place_batch(a: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous row block of a [B, ...] panel sharded over
    every rank (row order of the mesh), the panel first padded to a
    multiple of the mesh size with copies of row 0
    (``sqlp_tpu/sd/driver.py:544-549``)."""
    pad = (-a.shape[0]) % mesh.size
    if pad:
        a = torch.cat([a, a[:1].expand((pad,) + a.shape[1:])])
    block = a.shape[0] // mesh.size
    return a[mesh.world.index * block:(mesh.world.index + 1) * block]


def to_host(t: torch.Tensor, mesh: Mesh, axis: Optional[Axis] = None,
            dim: int = 0) -> np.ndarray:
    """A tensor sharded along ``axis`` (default: every rank, as
    ``place_batch`` shards) gathered and concatenated in rank order, as a
    host array on every rank."""
    return gather(t, mesh.world if axis is None else axis,
                  dim).detach().cpu().numpy()


def _digest(t: torch.Tensor) -> int:
    data = t.detach().cpu().contiguous().numpy().tobytes()
    return int.from_bytes(hashlib.sha256(data).digest()[:8], "little") >> 1


def check_replicated(state, mesh: Mesh) -> int:
    """Raise RuntimeError unless every replicated ``SDState`` field holds
    the same bits on every rank (one all-gather of per-field digests);
    returns the number of fields compared."""
    specs = mesh.specs()
    names = [f.name for f in dataclasses.fields(state)
             if not _field_axes(specs[f.name])]
    mine = torch.tensor([_digest(getattr(state, n)) for n in names],
                        dtype=torch.int64)
    if distributed.backend() == "nccl":
        mine = mine.to(state.it.device)
    got = torch.stack(all_gather(mine, mesh.world)).cpu()
    differ = [n for j, n in enumerate(names)
              if bool((got[:, j] != got[0, j]).any())]
    if differ:
        raise RuntimeError(f"replicated state fields differ across the "
                           f"{mesh.size} ranks: {differ}")
    return len(names)


def offset_of(axis: Optional[Axis], n_local: int) -> int:
    """The global index of this rank's first row of a dimension sharded in
    blocks of ``n_local`` along ``axis``."""
    return 0 if axis is None else axis.index * n_local
