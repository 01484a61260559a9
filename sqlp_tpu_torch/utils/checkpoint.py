"""Checkpoint / resume of the SD solver state.

Port of record: ``sqlp_tpu/utils/checkpoint.py`` (``save_state`` :25-42,
``load_state`` :45-104, ``load_meta`` :107-110). A checkpoint is a flat
``.npz`` of the ``SDState`` fields plus ``__meta_*`` scalars, the
reference package's schema, so a file written by either package loads in
the other:

* the port's trajectory is driven by the solver's ``torch.Generator``, so
  its state (a uint8 tensor: seed and offset) is stored under
  ``torch_generator_state``; restoring it continues the exact trajectory.
  The reference's loader reads only ``SDState``'s names and ignores it;
* the port also writes the reference's ``key`` field, uint32 ``[0, seed]``
  (the layout of ``jax.random.PRNGKey(seed)``), which the reference's
  loader requires. The port's loader ignores a ``key``; a file without a
  generator state (one the reference wrote) keeps the solver's seeded
  generator, with a warning.

A state sharded over a mesh (``parallel/mesh.py``) is saved whole: every
rank gathers the sharded fields and rank 0 writes the file, the layout of
the reference's ``save_state``. ``load_state(..., mesh=)`` reads the file
on every rank and shards it again, so a file written by one process
resumes on a mesh, and the reverse.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np
import torch

from sqlp_tpu_torch.parallel.mesh import gather_state, shard_state
from sqlp_tpu_torch.sd.state import SDState, state_from_numpy, state_to_numpy

_META_PREFIX = "__meta_"
GENERATOR_FIELD = "torch_generator_state"


def _prng_key(seed: int, state: SDState) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s uint32 pair, one per replication of a
    stacked state (whose cut_alpha is [R, E, K])."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    key = np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)
    if state.cut_alpha.dim() == 3:
        key = np.tile(key, (state.cut_alpha.shape[0], 1))
    return key


def save_state(path: str, state: SDState,
               generator: Optional[torch.Generator] = None, mesh=None,
               **meta) -> None:
    """Write the state (and the generator's state, and scalar metadata) to
    ``path`` as ``.npz``: to a temporary file first, then ``os.replace``d
    into place, so a reader never sees half a file. With a ``mesh`` every
    rank must call it (the sharded fields are gathered) and rank 0
    writes."""
    if mesh is not None:
        state = gather_state(state, mesh)
        if mesh.rank != 0:
            return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = state_to_numpy(state)
    seed = 0
    if generator is not None:
        payload[GENERATOR_FIELD] = generator.get_state().numpy()
        seed = generator.initial_seed()
    payload["key"] = _prng_key(seed, state)
    for k, v in meta.items():
        payload[_META_PREFIX + k] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path)


def load_state(path: str, template: Optional[SDState] = None,
               generator: Optional[torch.Generator] = None,
               mesh=None) -> SDState:
    """Restore an SDState. With a ``template`` (the solver's current state)
    shapes are checked against it (ValueError: the capacities must match)
    and its dtypes and device are adopted; without one the fields load as
    CPU tensors of the file's dtypes. With a ``generator`` its state is
    restored from the file's, when the file has one.

    Files that predate a field load with the reference's defaults:
    ``n_stream`` from ``total_weight`` (unit-weight streams), ``cut_x``
    from the incumbent (single and stacked shapes), scalar fields from
    the template with a warning; a missing array field raises. With a
    ``mesh`` (and the rank's sharded ``template``) every rank reads the
    file and keeps its part."""
    if mesh is not None:
        if template is None:
            raise ValueError("loading onto a mesh needs the rank's state "
                             "as the template")
        full = load_state(path, gather_state(template, mesh), generator)
        return shard_state(full, mesh)
    with np.load(path) as z:
        fields = {k: z[k] for k in z.files if not k.startswith(_META_PREFIX)}
    gen_state = fields.pop(GENERATOR_FIELD, None)
    names = [f.name for f in dataclasses.fields(SDState)]
    if "n_stream" not in fields and "total_weight" in fields:
        fields["n_stream"] = np.asarray(fields["total_weight"], np.int32)
    if "cut_x" not in fields and "cut_alpha" in fields:
        ca = fields["cut_alpha"]
        xi = np.asarray(fields["x_incumbent"])
        if ca.ndim == 2:
            fields["cut_x"] = np.broadcast_to(
                xi, ca.shape + xi.shape).copy()
        else:
            R, E, K = ca.shape
            fields["cut_x"] = np.broadcast_to(
                xi[:, None, None, :], (R, E, K, xi.shape[-1])).copy()
    missing = [n for n in names if n not in fields]
    if missing:
        defaultable = [n for n in missing if template is not None
                       and getattr(template, n).dim() == 0]
        if len(defaultable) < len(missing):
            raise ValueError(f"checkpoint {path} missing fields: "
                             f"{sorted(missing)}")
        warnings.warn(f"checkpoint {path} predates fields "
                      f"{sorted(defaultable)}; defaulting them from the "
                      f"current configuration")
        for n in defaultable:
            fields[n] = getattr(template, n).detach().cpu().numpy()
    if template is not None:
        state = state_from_numpy(fields, template)
    else:
        state = SDState(**{n: torch.as_tensor(np.array(fields[n]))
                           for n in names})
    if generator is not None:
        if gen_state is None:
            warnings.warn(f"checkpoint {path} holds no torch generator "
                          f"state (the JAX package wrote it?); the solver "
                          f"keeps its seeded generator, so the resumed "
                          f"stream differs from the original run's")
        else:
            generator.set_state(torch.as_tensor(gen_state,
                                                dtype=torch.uint8))
    return state


def load_meta(path: str) -> dict:
    """The ``__meta_*`` scalars of a checkpoint, by name."""
    with np.load(path) as z:
        return {k[len(_META_PREFIX):]: z[k].item()
                for k in z.files if k.startswith(_META_PREFIX)}
