"""Symmetry reduction on the GPU checker: the visited-set keys.

The port of the key function of the JAX package's device checker
(``checker/tpu.py::_make_key_fn``, ``sym_key_scheme``). Under symmetry the
visited set is keyed on a canonical fingerprint of each state's orbit under
the actor permutations, so dedup merges two states iff they share an orbit;
frontier rows, parent pointers, discoveries and paths keep the original
fingerprints, so paths replay through concrete states.

Three routes, chosen once from the model's hooks (``core/batch.py``):

- ``"custom"`` (``.symmetry_fn(f)``): the fingerprint of the model's
  ``packed_representative``; a model without that hook is refused, since
  the full-group keys would over-merge under a partial symmetry;
- ``"orbit"`` (no ``packed_refine_colors``): the exact orbit minimum, the
  least fingerprint over all ``n!`` permutations, swept in chunks of
  permutation rows a batched pass;
- ``"refined"``: ``rounds`` rounds of the model's equivariant color
  refinement, a stable sort of the colors (a candidate canonical
  permutation), the fingerprint of the permuted state, and ``n - 1``
  adjacent-transposition checks that every color tie is an automorphism.
  A lane whose check fails takes the orbit minimum instead.

The orbit minimum and the refined keys share ``finalize`` (a re-avalanche
and the fingerprints' sentinel nudges), so both draw from one key space.

Where the JAX package chooses the fallback with ``lax.cond`` on the
device, the port has two modes (``wave_keys``): exact, where the host reads
which valid lanes failed and computes their orbit minimum (the seed, the
wave path, a drain's final wave); and capturable, where no value is read
and the wave is told to hold back, inserting nothing, when any valid lane
failed (the deep drain's captured waves: the drain then stops and the host
runs that wave exactly).

Everything here is torch; u32 values ride in int64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.batch import BatchableModel, leaves, map_leaves
from ..ops.fingerprint import U32, avalanche32
from ..ops.hashset_kernel import sort_key, split_key

__all__ = [
    "CUSTOM_REP_SCHEME",
    "SYM_KEY_SCHEME",
    "SymmetryKeys",
    "finalize",
    "make_key_fn",
    "sym_key_scheme",
]

# The visited-key scheme of ``.symmetry()``: WL-canonical keys with a
# per-lane orbit-minimum fallback (the JAX package's tag, the same keys).
SYM_KEY_SCHEME = "wl-canon+orbitmin-v2"
# ``symmetry_fn`` runs key on the fingerprint of packed_representative.
CUSTOM_REP_SCHEME = "custom-representative-v1"

# Lanes of one batched pass of the orbit-minimum sweep: the failed lanes
# times the permutation rows of one chunk.
ORBIT_PASS_LANES = 1 << 16
_MAX_KEY = (1 << 63) - 1  # sort_key of the (MAX, MAX) pair


def sym_key_scheme(symmetry) -> Optional[str]:
    """The visited-key scheme tag a symmetry setting implies (None when
    symmetry is off)."""
    if symmetry is None:
        return None
    from .builder import default_representative

    return SYM_KEY_SCHEME if symmetry is default_representative else CUSTOM_REP_SCHEME


def finalize(khi: torch.Tensor, klo: torch.Tensor):
    """Re-avalanches orbit keys: an orbit minimum over |G| uniform draws
    concentrates in the low 1/|G| of the key space and would pile every
    home slot (the top bits of hi) into the table's first rows. fmix is a
    bijection on u32, so it adds no collision; the sentinels are nudged as
    the fingerprints nudge them."""
    khi = avalanche32(khi ^ 0x51A7CC9E)
    klo = avalanche32(klo ^ 0xE3779B97)
    klo = torch.where((khi == 0) & (klo == 0), 1, klo)
    klo = torch.where((khi == U32) & (klo == U32), U32 - 1, klo)
    return khi, klo


def make_key_fn(model, fp_fn, symmetry, device) -> Optional["SymmetryKeys"]:
    """The checker's symmetry keys for ``model`` (``fp_fn`` its
    ``packed_fingerprint``), or None when symmetry is off. Raises
    ``ValueError`` for a custom ``symmetry_fn`` on a model without
    ``packed_representative`` and ``TypeError`` for a model without
    ``packed_symmetry``, as the JAX package does."""
    if symmetry is None:
        return None
    from .builder import default_representative

    if symmetry is not default_representative:
        has_rep = (
            type(model).packed_representative is not BatchableModel.packed_representative
        )
        if not has_rep:
            raise ValueError(
                "the GPU checker cannot honor a custom symmetry_fn unless the model "
                "implements packed_representative(): the built-in keys reduce by the "
                "FULL actor-permutation group, which would over-merge states under a "
                "partial symmetry. Implement packed_representative (core/batch.py), "
                "use .symmetry(), or the host checker."
            )
        return SymmetryKeys(model, fp_fn, "custom", device)
    try:
        n2o, o2n = model.packed_symmetry()
    except (AttributeError, NotImplementedError) as e:
        raise TypeError(
            "symmetry on the GPU checker requires the model to implement "
            "packed_symmetry()/packed_apply_permutation() (see "
            f"stateright_tpu_torch.core.batch): {e}"
        ) from e
    has_refine = type(model).packed_refine_colors is not BatchableModel.packed_refine_colors
    return SymmetryKeys(model, fp_fn, "refined" if has_refine else "orbit", device,
                        (np.asarray(n2o), np.asarray(o2n)))


class SymmetryKeys:
    """The visited-set keys of one checker (see the module docstring).
    ``route`` is ``"custom"``, ``"orbit"`` or ``"refined"``; the
    permutation tables go to ``device`` here, before any capture. Counts
    the lanes whose keys took the orbit-minimum fallback
    (``fallback_lanes``, in ``fallback_waves`` batches)."""

    def __init__(self, model, fp_fn, route, device, tables=None):
        self.model = model
        self.fp_fn = fp_fn
        self.route = route
        self.fallback_waves = 0
        self.fallback_lanes = 0
        if tables is None:
            return
        n2o, o2n = (torch.from_numpy(t.astype(np.int64)).to(device) for t in tables)
        self._n2o, self._o2n = n2o, o2n
        n = n2o.shape[1]
        self.n = n
        # WL color partitions on n actors stabilize within n - 1 rounds.
        self.rounds = max(1, min(n - 1, 6))
        # Row i: the identity with i and i + 1 swapped.
        swap = np.tile(np.arange(n, dtype=np.int64), (max(n - 1, 1), 1))
        for i in range(n - 1):
            swap[i, i], swap[i, i + 1] = i + 1, i
        self._swap = torch.from_numpy(swap).to(device)
        self._iota = torch.arange(n, dtype=torch.int64, device=device)

    # -- the routes -------------------------------------------------------------

    def orbit_min(self, states):
        """The finalized orbit-minimum keys of a batch: the least (hi, lo)
        fingerprint over every permutation row, ``ORBIT_PASS_LANES``
        lanes a batched pass."""
        L = leaves(states)[0].shape[0]
        n2o, o2n = self._n2o, self._o2n
        P = n2o.shape[0]
        best = torch.full((L,), _MAX_KEY, dtype=torch.int64, device=n2o.device)
        if L:
            K = max(1, min(P, ORBIT_PASS_LANES // L))
            for s in range(0, P, K):
                k = min(K, P - s)
                rep = map_leaves(lambda x: x.repeat_interleave(k, dim=0), states)
                hi, lo = self.fp_fn(self.model.packed_apply_permutation(
                    rep, n2o[s:s + k].repeat(L, 1), o2n[s:s + k].repeat(L, 1)))
                best = torch.minimum(best, sort_key(hi, lo).view(L, k).min(dim=1).values)
        return finalize(*split_key(best))

    def _permuted_fp(self, states, n2o):
        o2n = torch.empty_like(n2o).scatter_(1, n2o, self._iota.expand_as(n2o))
        return self.fp_fn(self.model.packed_apply_permutation(states, n2o, o2n))

    def refined(self, states):
        """The WL-refined keys of a batch, before the fallback: ``(khi,
        klo, ok)``, finalized, with ``ok`` False on each lane whose color
        ties are not all verified automorphisms (its key is then not a
        canonical one)."""
        L = leaves(states)[0].shape[0]
        colors = torch.zeros((L, self.n), dtype=torch.int64, device=self._iota.device)
        for _ in range(self.rounds):
            colors = self.model.packed_refine_colors(states, colors)
        # A stable sort keeps ties in index order, as jax.lax.sort does.
        sorted_colors, cand = torch.sort(colors, dim=1, stable=True)
        hi0, lo0 = self._permuted_fp(states, cand)
        ok = torch.ones(L, dtype=torch.bool, device=cand.device)
        for i in range(self.n - 1):
            tie = sorted_colors[:, i] == sorted_colors[:, i + 1]
            hi, lo = self._permuted_fp(states, cand[:, self._swap[i]])
            ok = ok & (~tie | ((hi == hi0) & (lo == lo0)))
        khi, klo = finalize(hi0, lo0)
        return khi, klo, ok

    def custom(self, states):
        """The fingerprints of the model's ``packed_representative``: they
        carry the fingerprints' own sentinel nudges, so no finalize."""
        return self.fp_fn(self.model.packed_representative(states))

    # -- the checker's entry points ------------------------------------------------

    def wave_keys(self, states, valid, exact=True):
        """The keys of a batch whose ``valid`` lanes count: ``(khi, klo,
        hold)``. Exact: every valid lane's key is canonical (the host reads
        which lanes failed the refined check and computes their orbit
        minimum) and ``hold`` is None. Not exact (capturable, no host
        read): the refined keys as they are, and ``hold`` a 0-d bool tensor,
        True when a valid lane failed its check (the caller must then
        insert none of these keys)."""
        if self.route == "custom":
            khi, klo = self.custom(states)
            return khi, klo, None
        if self.route == "orbit":
            khi, klo = self.orbit_min(states)
            return khi, klo, None
        khi, klo, ok = self.refined(states)
        miss = ~ok & valid
        if not exact:
            return khi, klo, miss.any()
        lanes = torch.nonzero(miss).squeeze(1)
        if lanes.numel():
            fhi, flo = self.orbit_min(map_leaves(lambda x: x[lanes], states))
            khi = khi.index_put((lanes,), fhi)
            klo = klo.index_put((lanes,), flo)
            self.fallback_waves += 1
            self.fallback_lanes += int(lanes.numel())
        return khi, klo, None

    def keys(self, states):
        """The exact keys of every lane of a batch."""
        lanes = leaves(states)[0].shape[0]
        valid = torch.ones(lanes, dtype=torch.bool, device=leaves(states)[0].device)
        khi, klo, _ = self.wave_keys(states, valid)
        return khi, klo
