"""Packed actor systems: ``ActorModel`` transitions batched in torch.

The port of the JAX package's ``actor/packed.py``. The host ``ActorModel``
(``actor/model.py``) enumerates data-dependent action sets and runs
arbitrary Python actor callbacks (the reference's design,
``src/actor/model.rs:214-649``). ``PackedActorModel`` is its fixed-width
twin, written batched over a leading lane axis:

- **actor rows**: per-actor state packs into an ``(N, R)`` u32 matrix;
- **network**: an unordered network is a bounded ``(E,)``-slot envelope
  table (src, dst, msg words, count). Identical envelope multisets
  fingerprint identically because the fingerprint reduces the table to an
  order-insensitive multiset digest: no per-transition sort. An ordered
  network is one FIFO queue per directed flow, ``flow_msg (P, Q, W)`` and
  ``flow_len (P,)``, the head always at index 0 (a consume shifts the
  queue, so the arrays stay canonical): the reference's
  ``BTreeMap<(src, dst), VecDeque>`` flows (``src/actor/network.rs:46-68``).
  The ``P`` flows are all ``N²`` pairs (``src * N + dst``) or the pairs of
  ``with_flow_pairs``;
- **timers**: one bitmask word per actor;
- **crash faults**: an ``(N,)`` crashed vector when ``max_crashes`` is set,
  left out of the fingerprint as the host state hash leaves it out
  (``src/actor/model_state.rs:86-97``);
- **dense actions**, in the JAX package's action-id order: Deliver (one id
  per envelope slot, or per flow head), then Drop (lossy networks), then
  ``N × T`` Timeout ids, then ``N`` Crash ids (``max_crashes > 0``);
- **auxiliary history**: codecs with ``history_width > 0`` carry a packed
  history vector updated by the batched twins of ``record_msg_in`` and
  ``record_msg_out`` (see ``semantics/packed_linearizability.py``);
- **actor callbacks**: each actor type supplies a batched ``on_msg`` and
  ``on_timeout`` through an ``ActorPackedCodec``. The JAX package
  dispatches with ``lax.switch``, which under ``vmap`` runs every branch on
  every lane; so does this port: every actor type's branch runs over all
  lanes and ``torch.where`` selects.

The transition semantics mirror the host model exactly (no-op pruning,
deliver-before-send network effects, the fired timer cleared before the
callback's timer commands, the lowest free slot for a new envelope), so
packed and host checkers agree on exact state counts, and the port's
candidates equal the JAX package's lane for lane.

The fingerprint-only expansion is here too: ``packed_expand_fps`` gives
every candidate's fingerprint and validity from its parent's component
pairs and the components its transition touches, with no candidate state
made, and ``packed_take`` makes the children of chosen (row, action) pairs
only (the staged wave's default for these models, as in the JAX package).

Symmetry reduction is here too, as in the JAX package: the group action
``packed_apply_permutation`` (actor rows through the codec's
``rewrite_actor_row``, envelope ids and messages through
``rewrite_msg_ids``, flows re-indexed) and the generic equivariant color
refinement ``packed_refine_colors``, both batched with a permutation (or a
color vector) a lane. ``packed_symmetry`` refuses, as the JAX package does,
an auxiliary history (its client identities are not interchangeable) and
restricted ``flow_pairs`` (the pair set is not closed under permutations).

Everything the device checker runs here is capturable in a CUDA Graph: no
value is read back, no shape depends on data, and the constant tables
(hash coefficients, component seeds, the flow tables) are made once per
device on the first, uncaptured wave (``ops/fingerprint.py``).

u32 values ride in ``int64``, as everywhere in the port.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from ..core.batch import BatchableModel, gather_actors, lane_permutation
from ..ops.fingerprint import (
    U32,
    _xor_reduce,
    acc_finalize,
    avalanche32,
    combine_pairs,
    hash_rows,
    hash_rows_of,
    multiset_digest,
    multiset_row_pairs,
    pairs_acc,
)
from .actor import Id
from .model import ActorModel
from .model_state import ActorModelState
from .network import (
    Envelope,
    Network,
    ORDERED,
    UNORDERED_DUPLICATING,
    UNORDERED_NONDUPLICATING,
)
from .timers import Timers

_NET_KEYS = ("net_src", "net_dst", "net_msg", "net_cnt")
_FLOW_KEYS = ("flow_msg", "flow_len")


class ActorPackedCodec:
    """Model-specific packing contract consumed by ``PackedActorModel``.

    Widths are static. The batched kernels take and return int64 tensors
    carrying u32 values, with a leading lane axis ``L``:

    - ``on_msg`` branch (one per actor type):
      ``fn(id, row, src, msg) -> (row', sends, set_bits, cancel_bits,
      changed)`` with ``id``/``src`` ``(L,)``, ``row`` ``(L, R)``, ``msg``
      ``(L, W)``, ``sends`` ``(L, S, 1+W)`` (column 0 = destination id, or
      ``SEND_NONE`` for unused rows), timer masks ``(L,)`` and ``changed``
      ``(L,)`` bool (the analog of returning a new state vs ``None``).
    - ``on_timeout`` branch: ``fn(id, row, timer_bit) -> same``, with
      ``timer_bit`` ``(L,)``.
    """

    SEND_NONE = 0xFFFFFFFF

    msg_width: int
    state_width: int
    # timer value -> bit index by position.
    timer_values: Sequence[Any] = ()
    send_capacity: int
    # Auxiliary history (the reference's ``H``): 0 means "no history". A
    # codec with ``history_width > 0`` packs the history into a
    # ``(history_width,)`` u32 vector that rides in the packed state and
    # supplies the batched twins of ``record_msg_in``/``record_msg_out``.
    history_width: int = 0

    # -- host <-> packed conversions (numpy) --------------------------------

    def pack_actor_state(self, actor_index: int, state) -> np.ndarray:
        raise NotImplementedError

    def unpack_actor_state(self, actor_index: int, row: np.ndarray):
        raise NotImplementedError

    def pack_msg(self, msg) -> np.ndarray:
        raise NotImplementedError

    def unpack_msg(self, vec: np.ndarray):
        raise NotImplementedError

    def pack_history(self, history) -> np.ndarray:
        raise NotImplementedError

    def unpack_history(self, vec: np.ndarray):
        raise NotImplementedError

    # -- batched history hooks (history_width > 0 only) ----------------------

    def history_on_deliver(self, model, hist, src, dst, msg):
        """``record_msg_in`` twin: applied on Deliver with the envelope being
        delivered, BEFORE send commands are processed (host order)."""
        raise NotImplementedError

    def history_on_send(self, model, hist, src, dst, msg):
        """``record_msg_out`` twin: applied per Send command, in command
        order, to the already-updated history."""
        raise NotImplementedError

    # -- batched kernels ------------------------------------------------------

    def actor_type_id(self, actor_index: int, actor) -> int:
        return 0

    def on_msg_branches(self, model) -> List[Callable]:
        raise NotImplementedError

    def on_timeout_branches(self, model) -> List[Callable]:
        """Timer-free codecs (empty ``timer_values``) may return []."""
        return []

    # -- batched symmetry hooks (symmetry reduction only) ----------------------

    def rewrite_actor_row(self, model, rows, old_to_new):
        """Rewrites the actor ids embedded in packed rows under a relabeling:
        ``rows`` ``(L, N, R)``, ``old_to_new`` ``(L, n)``, lane ``l``'s actor
        ``i`` renamed ``old_to_new[l, i]``. The batched twin of the host
        ``rewrite_value`` over the actor state. The default is the identity,
        right ONLY for rows with no embedded ids. The refinement also calls
        it with colors (arbitrary u32 names), so an override must be
        value-wise and shift-safe for those."""
        return rows

    def rewrite_msg_ids(self, model, msgs, old_to_new):
        """The same for the ids embedded in packed messages: ``msgs``
        ``(L, ..., W)`` (envelope slots, or flows and queue slots),
        ``old_to_new`` ``(L, n)``."""
        return msgs

    # -- batched model hooks --------------------------------------------------

    def packed_conditions(self, model) -> List[Callable]:
        raise NotImplementedError

    def packed_within_boundary(self, model, states):
        rows = states["rows"]
        return torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)

    def packed_row_within_boundary(self, model, rows):
        """The boundary of single ``(L, R)`` actor rows: a codec whose
        ``packed_within_boundary`` is a per-row predicate (raft's term cap)
        states it here too, so that ``packed_within_boundary(states)`` equals
        every row passing this: the fingerprint-only wave
        (``PackedActorModel.packed_expand_fps``) checks only the row a
        transition changed."""
        return torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 when none is (as
    ``jnp.argmax`` of a bool vector)."""
    return mask.to(torch.uint8).argmax(dim=-1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """The set bits of each u32 lane of ``x`` (``lax.population_count``)."""
    return ((x[..., None] >> torch.arange(32, device=x.device)) & 1).sum(dim=-1)


def _bit(b: torch.Tensor) -> torch.Tensor:
    """``1 << b`` as u32 (b < 32)."""
    return (torch.ones_like(b) << b) & U32


class PackedActorModel(ActorModel, BatchableModel):
    """An ``ActorModel`` that also implements the packed protocol.

    Build it exactly like an ``ActorModel`` (``.actor()``,
    ``.init_network()``, ``.property()``, ...) and attach a codec; the
    packed side is validated on first use, so host-only checking of a
    configuration the packed side refuses still works."""

    def __init__(self, codec: ActorPackedCodec, cfg=None, init_history=None):
        super().__init__(cfg=cfg, init_history=init_history)
        self.codec = codec
        self.envelope_capacity = 32
        self.flow_capacity = 8
        self.flow_pairs = None
        self._device_tables = {}

    def with_envelope_capacity(self, capacity: int) -> "PackedActorModel":
        """Sets the network table's slot count (unordered networks). It must
        bound the reachable distinct-envelope count: overflowing transitions
        are pruned, which the exact-count parity tests surface as a
        mismatch."""
        self.envelope_capacity = capacity
        return self

    def with_flow_capacity(self, capacity: int) -> "PackedActorModel":
        """Sets the per-flow FIFO depth (ordered networks), with the same
        overflow semantics as ``with_envelope_capacity``."""
        self.flow_capacity = capacity
        return self

    def with_flow_pairs(self, pairs) -> "PackedActorModel":
        """Restricts ordered-network flows to the given directed
        ``(src, dst)`` pairs: the flow arrays and the deliver/drop action
        grid then scale with ``len(pairs)`` instead of ``N²``. A send outside
        the set behaves as a zero-capacity flow (the transition is pruned,
        as on ``with_flow_capacity`` overflow); host packing of such a state
        raises."""
        pairs = [(int(a), int(b)) for a, b in pairs]
        if len(set(pairs)) != len(pairs):
            raise ValueError("flow_pairs contains duplicates")
        self.flow_pairs = pairs
        return self

    def _pair_tables(self):
        """(lookup, src, dst) numpy tables of the ordered flows: ``lookup``
        maps ``src * N + dst`` to the flow index (-1 = an excluded pair);
        ``src``/``dst`` invert it per flow index. The identity layout when
        ``flow_pairs`` is unset."""
        N = self._N
        if self.flow_pairs is None:
            idx = np.arange(N * N, dtype=np.int32)
            return idx, (idx // N).astype(np.int32), (idx % N).astype(np.int32)
        lookup = np.full((N * N,), -1, np.int32)
        src = np.zeros((len(self.flow_pairs),), np.int32)
        dst = np.zeros_like(src)
        for k, (a, b) in enumerate(self.flow_pairs):
            if not (0 <= a < N and 0 <= b < N):
                raise ValueError(f"flow pair {(a, b)} out of range for N={N}")
            lookup[a * N + b] = k
            src[k], dst[k] = a, b
        return lookup, src, dst

    def _flow_tables(self, device):
        """``_pair_tables`` as int64 tensors on ``device``, made once per
        (device, layout): the first wave runs uncaptured, so no capture
        copies from the host."""
        key = (str(torch.device(device)), self._N,
               None if self.flow_pairs is None else tuple(self.flow_pairs))
        t = self._device_tables.get(key)
        if t is None:
            t = tuple(torch.from_numpy(x.astype(np.int64)).to(device)
                      for x in self._pair_tables())
            self._device_tables[key] = t
        return t

    # -- validation -----------------------------------------------------------

    def _packed_check(self):
        if self.init_history is not None and not self.codec.history_width:
            raise NotImplementedError(
                "this codec does not pack auxiliary history (declare "
                "history_width and the history hooks to stage it on device)"
            )

    # -- static shape helpers -------------------------------------------------

    @property
    def _N(self) -> int:
        return len(self.actors_list)

    @property
    def _E(self) -> int:
        return self.envelope_capacity

    @property
    def _Q(self) -> int:
        return self.flow_capacity

    @property
    def _P(self) -> int:
        """The directed flow count (ordered networks): all ``N²`` pairs laid
        out as ``src * N + dst``, or the length of ``flow_pairs``."""
        if self.flow_pairs is not None:
            return len(self.flow_pairs)
        return self._N * self._N

    @property
    def _T(self) -> int:
        return len(self.codec.timer_values)

    @property
    def _D(self) -> int:
        """Deliver (and drop) ids: one per flow head or envelope slot."""
        return self._P if self._ordered else self._E

    @property
    def _dup(self) -> bool:
        return self._init_network.kind == UNORDERED_DUPLICATING

    @property
    def _ordered(self) -> bool:
        return self._init_network.kind == ORDERED

    def _timer_bit(self, timer) -> int:
        return self.codec.timer_values.index(timer)

    def packed_action_count(self) -> int:
        self._packed_check()
        deliver_drop = self._D * (2 if self._lossy_network else 1)
        crash = self._N if self._max_crashes else 0
        return deliver_drop + self._N * self._T + crash

    def _type_of(self, actor: torch.Tensor) -> torch.Tensor:
        """Each lane's actor type id, from a where-chain over the actors
        (no host table reaches the device)."""
        t = torch.zeros_like(actor)
        for i, a in enumerate(self.actors_list):
            tid = self.codec.actor_type_id(i, a)
            if tid:
                t = torch.where(actor == i, tid, t)
        return t

    # -- host <-> packed state conversion ---------------------------------------

    def pack_state(self, sys_state: ActorModelState) -> Dict[str, torch.Tensor]:
        """One host state as int64 CPU tensors, without the lane axis."""
        self._packed_check()
        codec = self.codec
        N, E, W, R = self._N, self._E, codec.msg_width, codec.state_width
        rows = np.zeros((N, R), np.uint32)
        for i, actor_state in enumerate(sys_state.actor_states):
            rows[i] = codec.pack_actor_state(i, actor_state)
        timers = np.zeros((N,), np.uint32)
        for i, tset in enumerate(sys_state.timers_set):
            for t in tset:
                timers[i] |= np.uint32(1 << self._timer_bit(t))
        out = {"rows": rows, "timers": timers}
        if self._ordered:
            out.update(self._pack_flows(sys_state.network))
        else:
            out.update(self._pack_envelopes(sys_state.network))
        if self._max_crashes:
            out["crashed"] = np.array([1 if c else 0 for c in sys_state.crashed], np.uint32)
        if codec.history_width:
            hist = np.asarray(codec.pack_history(sys_state.history), np.uint32)
            if hist.shape != (codec.history_width,):
                raise ValueError(
                    f"pack_history returned shape {hist.shape}; expected "
                    f"({codec.history_width},)"
                )
            out["hist"] = hist
        return {k: torch.from_numpy(v.astype(np.int64)) for k, v in out.items()}

    def _pack_flows(self, network):
        N, P, Q, W = self._N, self._P, self._Q, self.codec.msg_width
        lookup, _, _ = self._pair_tables()
        flow_msg = np.zeros((P, Q, W), np.uint32)
        flow_len = np.zeros((P,), np.uint32)
        for (src, dst), msgs in network.data.items():
            if not msgs:
                continue
            if len(msgs) > Q:
                raise ValueError(
                    f"flow {src!r}->{dst!r} holds {len(msgs)} messages; "
                    f"flow_capacity={Q} is too small"
                )
            p = int(lookup[int(src) * N + int(dst)])
            if p < 0:
                raise ValueError(
                    f"flow {src!r}->{dst!r} holds messages but is not in flow_pairs"
                )
            flow_len[p] = len(msgs)
            for i, m in enumerate(msgs):
                flow_msg[p, i] = self.codec.pack_msg(m)
        return {"flow_msg": flow_msg, "flow_len": flow_len}

    def _pack_envelopes(self, network):
        E, W, codec = self._E, self.codec.msg_width, self.codec
        if self._init_network.kind == UNORDERED_NONDUPLICATING:
            items = list(network.data.items())
        else:
            items = [(env, 1) for env in network.data]
        if len(items) > E:
            raise ValueError(
                f"state has {len(items)} distinct envelopes; "
                f"envelope_capacity={E} is too small"
            )
        envs = sorted(
            (int(env.src), int(env.dst), tuple(int(x) for x in codec.pack_msg(env.msg)),
             int(count))
            for env, count in items
        )
        net_src = np.zeros((E,), np.uint32)
        net_dst = np.zeros((E,), np.uint32)
        net_msg = np.zeros((E, W), np.uint32)
        net_cnt = np.zeros((E,), np.uint32)
        for slot, (src, dst, msg, count) in enumerate(envs):
            net_src[slot], net_dst[slot], net_cnt[slot] = src, dst, count
            net_msg[slot] = msg
        return {"net_src": net_src, "net_dst": net_dst, "net_msg": net_msg,
                "net_cnt": net_cnt}

    def unpack_state(self, packed) -> ActorModelState:
        """One packed state (tensors or arrays, no lane axis) as a host
        state."""
        codec = self.codec
        p = {
            k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v).astype(np.uint32)
            for k, v in packed.items()
        }
        rows, timers = p["rows"], p["timers"]
        actor_states = [codec.unpack_actor_state(i, rows[i]) for i in range(self._N)]
        timers_set = []
        for i in range(self._N):
            tset = Timers()
            for b, timer in enumerate(codec.timer_values):
                if int(timers[i]) & (1 << b):
                    tset.set(timer)
            timers_set.append(tset)
        # An empty network of the model's kind: the packed state holds every
        # message, those of a non-empty initial network too.
        network = Network(self._init_network.kind)
        if self._ordered:
            _, psrc, pdst = self._pair_tables()
            for f in range(self._P):
                src, dst = Id(int(psrc[f])), Id(int(pdst[f]))
                for i in range(int(p["flow_len"][f])):
                    network.send(Envelope(src=src, dst=dst,
                                          msg=codec.unpack_msg(p["flow_msg"][f, i])))
        else:
            for slot in range(self._E):
                if int(p["net_cnt"][slot]):
                    env = Envelope(
                        src=Id(int(p["net_src"][slot])),
                        dst=Id(int(p["net_dst"][slot])),
                        msg=codec.unpack_msg(p["net_msg"][slot]),
                    )
                    for _ in range(int(p["net_cnt"][slot])):
                        network.send(env)
        history = codec.unpack_history(p["hist"]) if codec.history_width else None
        crashed = [False] * self._N
        if self._max_crashes:
            crashed = [bool(c) for c in p["crashed"]]
        return ActorModelState(
            actor_states=actor_states,
            network=network,
            timers_set=timers_set,
            crashed=crashed,
            history=history,
        )

    def packed_init_states(self, device="cpu"):
        self._packed_check()
        packed = [self.pack_state(s) for s in self.init_states()]
        return {k: torch.stack([p[k] for p in packed]).to(device) for k in packed[0]}

    # -- fingerprints -----------------------------------------------------------

    def _net_rows(self, states) -> torch.Tensor:
        """The ``(..., E, 3 + W)`` envelope rows ``[src, dst, msg..., cnt]``."""
        return torch.cat([
            states["net_src"][..., None], states["net_dst"][..., None],
            states["net_msg"], states["net_cnt"][..., None],
        ], dim=-1)

    def _flow_rows(self, states) -> torch.Tensor:
        """The ``(..., P, Q·W + 1)`` flow rows ``[queue words..., len]``."""
        fm = states["flow_msg"]
        return torch.cat([fm.reshape(fm.shape[:-2] + (-1,)), states["flow_len"][..., None]],
                         dim=-1)

    def packed_fingerprint_view(self, states):
        """The fingerprintable view of a batch: crash flags left out, and an
        unordered envelope table reduced to its order-insensitive multiset
        digest (``net_digest``, ``(L, 4)``); ordered flows are canonical
        (head at index 0) and stay as they are."""
        self._packed_check()
        out = {k: v for k, v in states.items() if k != "crashed"}
        if not self._ordered:
            for k in _NET_KEYS:
                out.pop(k)
            out["net_digest"] = multiset_digest(self._net_rows(states),
                                                states["net_cnt"] > 0)
        return out

    def packed_component_pairs(self, states):
        """Component-hash pairs of a batch: ``(his, los)``, each ``(L, C)``,
        one pair per component in a fixed order — the actors ``0..N-1``
        (actor row ‖ timer word; crash flags left out, as in the view), then
        the network: the flows ``N..N+P-1`` (queue ‖ length) of an ordered
        one, or one component ``N``, the multiset digest hashed as one row,
        of an unordered one; then the history, when the codec has one —
        each seeded by its tag."""
        self._packed_check()
        N = self._N
        rows_t = torch.cat([states["rows"], states["timers"][..., None]], dim=-1)
        ah, al = hash_rows(rows_t, range(N))
        if self._ordered:
            net_comps = self._P
            nh, nl = hash_rows(self._flow_rows(states), range(N, N + net_comps))
        else:
            net_comps = 1
            digest = multiset_digest(self._net_rows(states), states["net_cnt"] > 0)
            nh, nl = hash_rows(digest[..., None, :], (N,))
        his, los = [ah, nh], [al, nl]
        if self.codec.history_width:
            hh, hl = hash_rows(states["hist"][..., None, :], (N + net_comps,))
            his.append(hh)
            los.append(hl)
        return torch.cat(his, dim=-1), torch.cat(los, dim=-1)

    def packed_fingerprint(self, states):
        """Component-hash fingerprints (see ``packed_component_pairs``), each
        ``(L,)``: the same view semantics as ``packed_fingerprint_view``
        (crash flags left out, the envelope table hashed
        order-insensitively)."""
        return combine_pairs(*self.packed_component_pairs(states))

    def packed_comphash_layout(self) -> Dict[str, Any]:
        """What the fused wave's component-hash kernel
        (``csrc/fused_wave.cu::fw_comphash_keys``) needs to compute
        ``packed_fingerprint``: the leaves of each component group, each
        group's tag base, and the widths (``E`` is 0 on an ordered network,
        ``P`` and ``Q`` are 0 on an unordered one)."""
        self._packed_check()
        ordered = self._ordered
        net_comps = self._P if ordered else 1
        return {
            "actors": ("rows", "timers"),
            "ordered": ordered,
            "network": _FLOW_KEYS if ordered else _NET_KEYS,
            "history": "hist" if self.codec.history_width else None,
            "actor_tag": 0,
            "network_tag": self._N,
            "history_tag": self._N + net_comps,
            "N": self._N,
            "R": self.codec.state_width,
            "E": 0 if ordered else self._E,
            "P": self._P if ordered else 0,
            "Q": self._Q if ordered else 0,
            "W": self.codec.msg_width,
            "H": self.codec.history_width,
        }

    # -- symmetry (orbit-proper; see core/batch.py) ------------------------------

    def packed_symmetry(self):
        from ..core.batch import permutation_tables

        if self.codec.history_width:
            raise NotImplementedError(
                "symmetry with packed auxiliary history is unsupported (histories "
                "carry client identities that are not interchangeable)"
            )
        if self.flow_pairs is not None:
            raise NotImplementedError(
                "full-group symmetry with restricted flow_pairs is unsupported (the "
                "pair set is generally not closed under actor permutations)"
            )
        return permutation_tables(self._N)

    def packed_apply_permutation(self, states, new_to_old, old_to_new):
        """The symmetry group action on a batch of packed system states:
        gather the actor-indexed leaves by ``new_to_old`` and rewrite the
        embedded ids through the codec's hooks (the host
        ``ActorModelState._permuted``), a permutation a lane or one shared.
        The envelope table needs no re-sort: the fingerprint digests it
        order-insensitively."""
        codec = self.codec
        n = self._N
        L = states["rows"].shape[0]
        n2o = lane_permutation(new_to_old, L)
        o2n = lane_permutation(old_to_new, L)
        rows = codec.rewrite_actor_row(self, gather_actors(states["rows"], n2o), o2n)
        out = dict(states, rows=rows, timers=gather_actors(states["timers"], n2o))
        if "crashed" in states:
            out["crashed"] = gather_actors(states["crashed"], n2o)
        if self._ordered:
            if self.flow_pairs is not None:
                raise NotImplementedError(
                    "permutation action with restricted flow_pairs is unsupported"
                )
            # Flow (a, b) of the permuted state held flow
            # (new_to_old[a], new_to_old[b]); queue order is kept, so the
            # gathered table stays positionally canonical.
            flow = (n2o[:, :, None] * n + n2o[:, None, :]).reshape(L, n * n)
            fmsg = codec.rewrite_msg_ids(self, gather_actors(states["flow_msg"], flow), o2n)
            flen = gather_actors(states["flow_len"], flow)
            # Queue padding re-zeroed, so id rewrites of dead slots cannot
            # perturb the canonical array.
            slot = torch.arange(fmsg.shape[2], device=fmsg.device)
            fmsg = torch.where(slot[None, None, :, None] < flen[:, :, None, None], fmsg, 0)
            out.update(flow_msg=fmsg, flow_len=flen)
        else:
            occ = states["net_cnt"] > 0
            src = torch.where(occ, torch.gather(o2n, 1, states["net_src"]), 0)
            dst = torch.where(occ, torch.gather(o2n, 1, states["net_dst"]), 0)
            msg = codec.rewrite_msg_ids(self, states["net_msg"], o2n)
            msg = torch.where(occ[:, :, None], msg, 0)
            out.update(net_src=src, net_dst=dst, net_msg=msg)
        return out

    def packed_refine_colors(self, states, colors):
        """The generic equivariant WL round of packed actor systems (see
        ``core/batch.py``), batched: each actor's new color hashes its own
        row (embedded ids replaced by their colors through the codec's
        ``rewrite_actor_row``/``rewrite_msg_ids``), its timer bits, the
        actors whose rows reference it, and commutative digests of its
        incoming and outgoing envelopes tagged with the peer's color.
        ``crashed`` is left out, as the fingerprint leaves it out."""
        codec = self.codec
        n = self._N
        rows = states["rows"]

        def rows_under(c):
            return codec.rewrite_actor_row(self, rows, c)

        rows_c = rows_under(colors)
        acc = (colors * 0x9E3779B1 + 0x7F4A7C15) & U32
        for j in range(rows_c.shape[2]):
            acc = ((acc * 0x01000193) & U32) ^ rows_c[:, :, j]
        acc = avalanche32(((acc * 0x01000193) & U32) ^ states["timers"])

        # Reverse row-references: a row that embeds actor j's id informs
        # only the referrer's color, so actor j also learns who references
        # it (else WL leaves non-automorphic actors tied and each such tie
        # pays the fallback). Rewrites gather by index, so perturbing j's
        # name changes exactly the rows that reference j.
        hcol = avalanche32((colors * 0x27D4EB2F + 0x165667B1) & U32)
        rev = []
        for j in range(n):
            cj = colors.clone()
            cj[:, j] = colors[:, j] ^ 0x80000001
            refs = (rows_under(cj) != rows_c).any(dim=2)
            rev.append(torch.where(refs, hcol, 0).sum(dim=1) & U32)
        acc = avalanche32(acc ^ ((torch.stack(rev, dim=1) * 0x9E3779B7) & U32))

        def tagged(h, peer, mult, add):
            return avalanche32(h ^ ((peer * mult + add) & U32))

        L = colors.shape[0]
        if self._ordered:
            Q = self._Q
            fmsg_c = codec.rewrite_msg_ids(self, states["flow_msg"], colors)
            flen = states["flow_len"]
            live = torch.arange(Q, device=flen.device)[None, None, :] < flen[:, :, None]
            h = torch.full_like(flen, 0x811C9DC5)
            for q in range(Q):
                hq = h
                for w in range(fmsg_c.shape[3]):
                    hq = ((hq * 0x01000193) & U32) ^ fmsg_c[:, :, q, w]
                h = torch.where(live[:, :, q], hq, h)
            h = avalanche32(h ^ ((flen * 0x9E3779B9) & U32))
            _, psrc, pdst = self._flow_tables(flen.device)
            out_c = tagged(h, colors[:, pdst], 0xCC9E2D51, 0x52DCE729)
            in_c = tagged(h, colors[:, psrc], 0x1B873593, 0x38495AB5)
            zero = torch.zeros((L, n), dtype=torch.int64, device=flen.device)
            out_sum = zero.index_add(1, psrc, out_c) & U32
            in_sum = zero.index_add(1, pdst, in_c) & U32
        else:
            msg_c = codec.rewrite_msg_ids(self, states["net_msg"], colors)
            cnt = states["net_cnt"]
            occ = cnt > 0
            h = torch.full_like(cnt, 0x811C9DC5)
            for w in range(msg_c.shape[2]):
                h = ((h * 0x01000193) & U32) ^ msg_c[:, :, w]
            h = avalanche32(h ^ ((cnt * 0x9E3779B9) & U32))
            src, dst = states["net_src"], states["net_dst"]
            out_c = torch.where(occ, tagged(h, torch.gather(colors, 1, dst), 0xCC9E2D51,
                                            0x52DCE729), 0)
            in_c = torch.where(occ, tagged(h, torch.gather(colors, 1, src), 0x1B873593,
                                           0x38495AB5), 0)
            zero = torch.zeros((L, n), dtype=torch.int64, device=cnt.device)
            out_sum = zero.scatter_add(1, src, out_c) & U32
            in_sum = zero.scatter_add(1, dst, in_c) & U32
        return avalanche32(
            acc ^ ((out_sum * 0x85EBCA6B) & U32) ^ ((in_sum * 0xC2B2AE35) & U32)
        )

    # -- batched transition --------------------------------------------------------

    def _net_send(self, state, src, dst, msg, active):
        """One network send per lane (host ``Network.send``): a duplicating
        network keeps one copy, a non-duplicating one counts, an ordered one
        appends to the (src, dst) flow. A new envelope takes the lowest free
        slot, as the JAX package's ``argmax`` does (deliver action ids are
        slot indices, so the slot decides parents and paths). Returns
        (state, overflow)."""
        if self._ordered:
            return self._flow_send(state, src, dst, msg, active)
        E = self._E
        cnt = state["net_cnt"]
        match = (
            (state["net_src"] == src[:, None])
            & (state["net_dst"] == dst[:, None])
            & (state["net_msg"] == msg[:, None, :]).all(dim=-1)
            & (cnt > 0)
        )
        exists = match.any(dim=-1)
        empty = cnt == 0
        has_empty = empty.any(dim=-1)
        slot = torch.where(exists, _first_true(match), _first_true(empty))
        ok = active & (exists | has_empty)
        at = torch.arange(E, device=cnt.device) == slot[:, None]
        add = (~exists).to(cnt.dtype)[:, None] if self._dup else 1
        state = dict(state)
        state["net_cnt"] = cnt + torch.where(at & ok[:, None], add, 0)
        w = at & (ok & ~exists)[:, None]
        state["net_src"] = torch.where(w, src[:, None], state["net_src"])
        state["net_dst"] = torch.where(w, dst[:, None], state["net_dst"])
        state["net_msg"] = torch.where(w[:, :, None], msg[:, None, :], state["net_msg"])
        return state, active & ~exists & ~has_empty

    def _flow_send(self, state, src, dst, msg, active):
        """The ordered ``_net_send``: append ``msg`` at the tail of flow
        (src, dst). A full flow, or a pair outside ``flow_pairs`` (a
        zero-capacity flow), overflows and the lane is pruned."""
        N, P, Q = self._N, self._P, self._Q
        lookup, _, _ = self._flow_tables(src.device)
        p = lookup[(src * N + dst).clamp(0, N * N - 1)]
        allowed = p >= 0
        at_p = torch.arange(P, device=src.device) == p[:, None]  # (L, P); none when -1
        length = (state["flow_len"] * at_p).sum(dim=1)
        ok = active & allowed & (length < Q)
        at_q = torch.arange(Q, device=src.device) == length.clamp(0, Q - 1)[:, None]
        w = at_p[:, :, None] & at_q[:, None, :] & ok[:, None, None]  # (L, P, Q)
        state = dict(state)
        state["flow_msg"] = torch.where(w[..., None], msg[:, None, None, :],
                                        state["flow_msg"])
        state["flow_len"] = state["flow_len"] + (at_p & ok[:, None]).to(torch.int64)
        return state, active & (~allowed | (length >= Q))

    def _apply_callback(self, state, actor, row_new, sends, set_bits, cancel_bits,
                        fired_bit=None):
        """Applies a callback's effects per lane: the row write, the timer
        bookkeeping (the fired timer cleared first, then the sets, then the
        cancels, as the host processes the commands), then the sends in
        command order, each followed by the history's ``record_msg_out``
        twin. Returns (state, overflow)."""
        codec = self.codec
        state = dict(state)
        own = torch.arange(self._N, device=actor.device) == actor[:, None]  # (L, N)
        state["rows"] = torch.where(own[:, :, None], row_new[:, None, :], state["rows"])
        t = (state["timers"] * own).sum(dim=1)
        if fired_bit is not None:
            t = t & (~_bit(fired_bit) & U32)
        t = (t | set_bits) & (~cancel_bits & U32)
        state["timers"] = torch.where(own, t[:, None], state["timers"])
        overflow = torch.zeros_like(actor, dtype=torch.bool)
        for s in range(codec.send_capacity):
            dst, msg = sends[:, s, 0], sends[:, s, 1:]
            active = dst != codec.SEND_NONE
            state, ov = self._net_send(state, actor, dst, msg, active)
            if codec.history_width:
                hist = codec.history_on_send(self, state["hist"], actor, dst, msg)
                state["hist"] = torch.where(active[:, None], hist, state["hist"])
            overflow = overflow | ov
        return state, overflow

    def _select(self, outs, actor):
        """The callback result of each lane's actor type from every
        branch's ``outs``, as ``lax.switch`` picks it (a type id past the
        last branch takes the last)."""
        row_new, sends, set_bits, cancel_bits, changed = outs[0]
        if len(outs) > 1:
            kind = self._type_of(actor).clamp(max=len(outs) - 1)
            for k, o in enumerate(outs[1:], start=1):
                sel = kind == k
                row_new = torch.where(sel[:, None], o[0], row_new)
                sends = torch.where(sel[:, None, None], o[1], sends)
                set_bits = torch.where(sel, o[2], set_bits)
                cancel_bits = torch.where(sel, o[3], cancel_bits)
                changed = torch.where(sel, o[4], changed)
        return row_new, sends, set_bits, cancel_bits, changed

    @staticmethod
    def _lanes(states, k):
        """Each state repeated ``k`` times: leaves ``(F * k, ...)``, lane
        ``(f, j)`` at ``f * k + j``."""
        return {
            key: v[:, None].expand((v.shape[0], k) + v.shape[1:]).reshape(
                (v.shape[0] * k,) + v.shape[1:])
            for key, v in states.items()
        }

    def _env_at(self, states):
        """``(present, src, dst, msg)`` of every deliver/drop lane
        ``(f, slot)``, flattened: the flow heads of an ordered network or
        the envelope slots of an unordered one."""
        F, D, W = states["rows"].shape[0], self._D, self.codec.msg_width
        if self._ordered:
            _, psrc, pdst = self._flow_tables(states["rows"].device)
            return (
                states["flow_len"].reshape(F * D) > 0,
                psrc.repeat(F),
                pdst.repeat(F),
                states["flow_msg"][:, :, 0].reshape(F * D, W),
            )
        return (
            states["net_cnt"].reshape(F * D) > 0,
            states["net_src"].reshape(F * D),
            states["net_dst"].reshape(F * D),
            states["net_msg"].reshape(F * D, W),
        )

    def _consume(self, st, at):
        """Removes the message of each lane's slot (``at``: ``(L, D)``
        one-hot): an ordered flow's head shifts out (the head stays at index
        0), an envelope's count drops by one."""
        st = dict(st)
        if self._ordered:
            fm = st["flow_msg"]
            shifted = torch.cat([fm[:, :, 1:], torch.zeros_like(fm[:, :, :1])], dim=2)
            st["flow_msg"] = torch.where(at[:, :, None, None], shifted, fm)
            st["flow_len"] = (st["flow_len"] - at.to(torch.int64)) & U32
        else:
            st["net_cnt"] = (st["net_cnt"] - at.to(torch.int64)) & U32
        return st

    def _crashed_at(self, st, actor):
        if not self._max_crashes:
            return torch.zeros_like(actor, dtype=torch.bool)
        own = torch.arange(self._N, device=actor.device) == actor[:, None]
        return ((st["crashed"] * own).sum(dim=1)) == 1

    def _crashed_rows(self, par, actor, states):
        """Whether ``actor`` is crashed in parent row ``par`` of ``states``,
        lane by lane."""
        if not self._max_crashes:
            return torch.zeros_like(actor, dtype=torch.bool)
        return states["crashed"][par, actor] == 1

    def _slot_onehot(self, F, D, device):
        return torch.eye(D, dtype=torch.bool, device=device).repeat(F, 1)

    def _env_of(self, st, slot):
        """``(present, src, dst, msg)`` of each lane's own deliver/drop
        ``slot`` (``(L,)``, in ``0..D-1``) over the lanes' states ``st``: the
        head of that flow of an ordered network, or that envelope slot of an
        unordered one."""
        lane = torch.arange(slot.shape[0], device=slot.device)
        if self._ordered:
            _, psrc, pdst = self._flow_tables(slot.device)
            return (st["flow_len"][lane, slot] > 0, psrc[slot], pdst[slot],
                    st["flow_msg"][lane, slot, 0])
        return (st["net_cnt"][lane, slot] > 0, st["net_src"][lane, slot],
                st["net_dst"][lane, slot], st["net_msg"][lane, slot])

    def _deliver(self, st, present, env_src, env_dst, env_msg, at):
        """The deliver class over L lanes: each lane's state ``st``, the
        envelope it delivers (``present``, ``env_src``, ``env_dst``,
        ``env_msg``) and ``at``, the ``(L, D)`` one-hot of its slot. Returns
        ``(children, valid)``."""
        codec = self.codec
        N = self._N
        actor = env_dst.clamp(0, N - 1)
        row = st["rows"].gather(1, actor[:, None, None].expand(-1, 1, codec.state_width))[:, 0]
        row_new, sends, set_bits, cancel_bits, changed = self._select(
            [fn(actor, row, env_src, env_msg) for fn in codec.on_msg_branches(self)], actor)
        no_sends = (sends[:, :, 0] == codec.SEND_NONE).all(dim=1)
        is_no_op = ~changed & no_sends & (set_bits == 0) & (cancel_bits == 0)
        out = dict(st)
        if codec.history_width:
            out["hist"] = codec.history_on_deliver(self, st["hist"], env_src, env_dst,
                                                   env_msg)
        if self._ordered or not self._dup:
            out = self._consume(out, at)
        # A no-op delivery on an ordered network still consumes the message
        # but applies no other effect (the host skips the callback result).
        out, ov = self._apply_callback(
            out,
            actor,
            torch.where(is_no_op[:, None], row, row_new),
            torch.where(is_no_op[:, None, None], codec.SEND_NONE, sends),
            torch.where(is_no_op, 0, set_bits),
            torch.where(is_no_op, 0, cancel_bits),
        )
        valid = present & (env_dst < N) & ~self._crashed_at(st, actor) & ~ov
        if not self._ordered:
            valid = valid & ~is_no_op
        return out, valid

    def _drop(self, st, at):
        """The drop class over L lanes: each lane's message at its slot
        (``at``, ``(L, D)`` one-hot) lost; its children."""
        if self._dup:
            out = dict(st)
            out["net_cnt"] = torch.where(at, 0, st["net_cnt"])
            return out
        return self._consume(st, at)

    def _timeout(self, st, actor, bit):
        """The timeout class over L lanes: timer ``bit`` of ``actor`` fires
        in each lane's state ``st``. Returns ``(children, valid)``."""
        codec = self.codec
        row = st["rows"].gather(1, actor[:, None, None].expand(-1, 1, codec.state_width))[:, 0]
        row_new, sends, set_bits, cancel_bits, changed = self._select(
            [fn(actor, row, bit) for fn in codec.on_timeout_branches(self)], actor)
        renews_only = (
            ~changed
            & (sends[:, :, 0] == codec.SEND_NONE).all(dim=1)
            & (cancel_bits == 0)
            & (set_bits == _bit(bit))
        )
        own = torch.arange(self._N, device=actor.device) == actor[:, None]
        timer_set = (((st["timers"] * own).sum(dim=1) >> bit) & 1) == 1
        out, ov = self._apply_callback(st, actor, row_new, sends, set_bits, cancel_bits,
                                       fired_bit=bit)
        return out, timer_set & ~renews_only & ~ov

    def _crash(self, st, own):
        """The crash class over L lanes: the actor of each lane's ``own``
        (``(L, N)`` one-hot) crashes, its timers cleared; its children."""
        out = dict(st)
        out["crashed"] = torch.where(own, 1, st["crashed"])
        out["timers"] = torch.where(own, 0, st["timers"])
        return out

    def _expand_deliver(self, states):
        F, D = states["rows"].shape[0], self._D
        return self._deliver(self._lanes(states, D), *self._env_at(states),
                             self._slot_onehot(F, D, states["rows"].device))

    def _expand_drop(self, states):
        F, D = states["rows"].shape[0], self._D
        at = self._slot_onehot(F, D, states["rows"].device)
        return self._drop(self._lanes(states, D), at), self._env_at(states)[0]

    def _expand_timeout(self, states):
        N, T = self._N, self._T
        F = states["rows"].shape[0]
        k = torch.arange(N * T, device=states["rows"].device).repeat(F)
        return self._timeout(self._lanes(states, N * T), k // T, k % T)

    def _expand_crash(self, states):
        N = self._N
        F = states["rows"].shape[0]
        own = torch.eye(N, dtype=torch.bool, device=states["rows"].device).repeat(F, 1)
        crashed = states["crashed"]
        valid = (crashed.sum(dim=1) < self._max_crashes)[:, None] & (crashed == 0)
        return self._crash(self._lanes(states, N), own), valid.reshape(F * N)

    def _class_bounds(self):
        """The action classes in id order, each ``(name, first id, ids)``:
        deliver, drop (lossy networks), timeout, crash (``max_crashes``)."""
        D, N, T = self._D, self._N, self._T
        out, off = [("deliver", 0, D)], D
        if self._lossy_network:
            out.append(("drop", off, D))
            off += D
        if T:
            out.append(("timeout", off, N * T))
            off += N * T
        if self._max_crashes:
            out.append(("crash", off, N))
        return out

    def packed_take(self, states, action_ids):
        """One child for each row: row ``l``'s child by action
        ``action_ids[l]``, exactly the candidate ``packed_expand`` gives it
        there (the JAX package's ``packed_take``, written over a batch).
        Each class's code runs once over the rows, with the ids clamped to
        its range, and each row keeps its own class's child: its cost is the
        classes times the rows, which the checker keeps to the fresh lanes
        of a wave (never the F × A grid)."""
        self._packed_check()
        N, T, D = self._N, self._T, self._D
        aid = action_ids.to(torch.int64)
        dev = aid.device
        out = None
        for name, first, n in self._class_bounds():
            k = (aid - first).clamp(0, n - 1)
            if name == "deliver":
                at = torch.arange(D, device=dev) == k[:, None]
                child = self._deliver(states, *self._env_of(states, k), at)[0]
            elif name == "drop":
                child = self._drop(states, torch.arange(D, device=dev) == k[:, None])
            elif name == "timeout":
                child = self._timeout(states, k // T, k % T)[0]
            else:
                child = self._crash(states, torch.arange(N, device=dev) == k[:, None])
            if out is None:
                out = child
                continue
            mine = aid >= first
            out = {key: torch.where(mine.view((-1,) + (1,) * (v.dim() - 1)), child[key], v)
                   for key, v in out.items()}
        return {key: out[key] for key in states}

    def packed_expand_fps_supported(self) -> bool:
        """The fingerprint-only wave checks the boundary only on the row a
        transition changed: a codec that states its own
        ``packed_within_boundary`` must state ``packed_row_within_boundary``
        too, or the fps wave would admit children outside the boundary
        (the JAX package's veto)."""
        codec_cls = type(self.codec)
        wb_custom = (codec_cls.packed_within_boundary
                     is not ActorPackedCodec.packed_within_boundary)
        row_custom = (codec_cls.packed_row_within_boundary
                      is not ActorPackedCodec.packed_row_within_boundary)
        return (not wb_custom) or row_custom

    def packed_expand_fps(self, states):
        """The fingerprints and validity of all ``A`` children of each of F
        states, without making the children: ``(hi, lo, valid)``, each
        ``(F, A)``, ``(hi, lo)`` equal to ``packed_fingerprint`` of the
        ``packed_expand`` candidate on every valid lane and ``valid`` equal
        to its validity and ``packed_within_boundary`` of the child (the
        JAX package's ``packed_expand_fps``). Each child's fingerprint is
        its parent's component-pair accumulator (``packed_component_pairs``)
        with the components its transition touches swapped: the changed
        actor row, the consumed and appended flows of an ordered network or
        the multiset digest of an unordered one, adjusted by the rows it
        removes and adds, and the history. The boundary is checked on the
        changed row (``packed_row_within_boundary``)."""
        self._packed_check()
        codec = self.codec
        N, T, W, D = self._N, self._T, codec.msg_width, self._D
        ordered, dup = self._ordered, self._dup
        S = codec.send_capacity
        K = 1 + S  # working-set slots: the consumed row and one a send
        hist_w = codec.history_width
        net_comps = self._P if ordered else 1
        hist_tag = N + net_comps
        C = N + net_comps + (1 if hist_w else 0)
        F = states["rows"].shape[0]
        dev = states["rows"].device
        phis, plos = self.packed_component_pairs(states)
        parent_acc = pairs_acc(phis, plos)
        parent_digest = None
        if not ordered:
            parent_digest = multiset_digest(self._net_rows(states), states["net_cnt"] > 0)

        def lanes_of(k):
            """Each lane's parent row, ``k`` lanes a parent."""
            return torch.arange(F, device=dev).repeat_interleave(k)

        def row_pair(words, tags):
            return hash_rows_of(words[:, None, :], tags[:, None], C)

        def actor_pair(actor, row, tmr):
            h, l = row_pair(torch.cat([row, tmr[:, None]], dim=1), actor)
            return h[:, 0], l[:, 0]

        def flow_pair(pid, q, ln):
            words = torch.cat([q.reshape(q.shape[0], -1), ln[:, None]], dim=1)
            h, l = row_pair(words, N + pid)
            return h[:, 0], l[:, 0]

        def tagged_pair(row, tag):
            h, l = hash_rows(row[:, None, :], (tag,))
            return h[:, 0], l[:, 0]

        def final_fp(par, subs):
            """The parent's accumulator with each candidate's components
            swapped; ``subs`` are ``(component, hi, lo, enabled)`` (enabled
            None: always), each ``(L,)`` or ``(L, K)`` for K components a
            lane, distinct components for one lane."""
            acc = parent_acc[par]
            sh, xh, sl, xl = acc.unbind(dim=1)
            for ci, nh, nl, en in subs:
                rows = par if nh.dim() == 1 else par[:, None]
                oh, ol = phis[rows, ci], plos[rows, ci]
                dh = nh if en is None else torch.where(en, nh, oh)
                dl = nl if en is None else torch.where(en, nl, ol)
                dsh, dxh, dsl, dxl = dh - oh, dh ^ oh, dl - ol, dl ^ ol
                if nh.dim() == 2:
                    dsh, dxh = dsh.sum(dim=1), _xor_reduce(dxh)
                    dsl, dxl = dsl.sum(dim=1), _xor_reduce(dxl)
                sh, xh, sl, xl = sh + dsh, xh ^ dxh, sl + dsl, xl ^ dxl
            return acc_finalize(torch.stack([sh & U32, xh, sl & U32, xl], dim=1), C)

        def digest_adjust(digest, src, dst, msg, old_cnt, new_cnt, en):
            """The digest less the old contributions of K rows a lane plus
            their new ones, as ``multiset_digest`` folds active rows:
            ``src``, ``dst``, the counts and ``en`` are ``(L, K)``, ``msg``
            ``(L, K, W)``; all 2K row hashes in one ``multiset_row_pairs``."""
            ends = torch.stack([src, dst], dim=2)[:, None].expand(-1, 2, -1, -1)
            cnt = torch.stack([old_cnt, new_cnt], dim=1)
            rows = torch.cat([ends, msg[:, None].expand(-1, 2, -1, -1), cnt[..., None]], dim=3)
            h, l = multiset_row_pairs(rows)
            on = en[:, None] & (cnt > 0)
            h, l = torch.where(on, h, 0), torch.where(on, l, 0)
            L = h.shape[0]
            return torch.stack([
                (digest[:, 0] - h[:, 0].sum(dim=1) + h[:, 1].sum(dim=1)) & U32,
                digest[:, 1] ^ _xor_reduce(h.reshape(L, -1)),
                (digest[:, 2] - l[:, 0].sum(dim=1) + l[:, 1].sum(dim=1)) & U32,
                digest[:, 3] ^ _xor_reduce(l.reshape(L, -1)),
            ], dim=1)

        def pick(x, j):
            """Row ``j[l]`` of each lane's ``x[l]``."""
            return x[torch.arange(x.shape[0], device=dev), j]

        def flows_apply(par, init, sends, src):
            """The sends applied in order to a working set of the K flow
            rows a transition touches (``_flow_send``, with its overflow
            and excluded-pair pruning), without copying the flow table."""
            L, P, Q = par.shape[0], self._P, self._Q
            lookup, _, _ = self._flow_tables(dev)
            ids = torch.full((L, K), -1, dtype=torch.int64, device=dev)
            qs = torch.zeros((L, K, Q, W), dtype=torch.int64, device=dev)
            lns = torch.zeros((L, K), dtype=torch.int64, device=dev)
            if init is not None:
                slot, q0, ln0 = init
                ids[:, 0], qs[:, 0], lns[:, 0] = slot, q0, ln0
            ov = torch.zeros(L, dtype=torch.bool, device=dev)
            slots = torch.arange(K, device=dev)
            for si in range(S):
                dst, msg = sends[:, si, 0], sends[:, si, 1:]
                active = dst != codec.SEND_NONE
                p = lookup[(src * N + dst).clamp(0, N * N - 1)]
                allowed = p >= 0
                p = p.clamp(0, P - 1)
                match = ids == p[:, None]
                found = match.any(dim=1)
                j = torch.where(found, _first_true(match), _first_true(ids < 0))
                base_q = torch.where(found[:, None, None], pick(qs, j),
                                     states["flow_msg"][par, p])
                base_ln = torch.where(found, pick(lns, j), states["flow_len"][par, p])
                ok = active & allowed & (base_ln < Q)
                row_at = torch.arange(Q, device=dev) == base_ln.clamp(0, Q - 1)[:, None]
                nq = torch.where((row_at & ok[:, None])[:, :, None], msg[:, None, :], base_q)
                nln = base_ln + ok.to(torch.int64)
                sel = (slots == j[:, None]) & (active & allowed)[:, None]
                ids = torch.where(sel, p[:, None], ids)
                qs = torch.where(sel[:, :, None, None], nq[:, None], qs)
                lns = torch.where(sel, nln[:, None], lns)
                ov = ov | (active & (~allowed | (base_ln >= Q)))
            words = torch.cat([qs.reshape(L, K, Q * W), lns[:, :, None]], dim=2)
            h, l = hash_rows_of(words, N + ids, C)
            return [(N + ids, h, l, ids >= 0)], ov

        def net_apply(par, cons_slot, sends, src):
            """The sends applied in order to the parent's multiset digest
            through a working set of the K (src, dst, msg) rows a
            transition touches (``_net_send``: a duplicating network keeps
            one copy, a non-duplicating one counts; only the count of empty
            slots matters for overflow). ``cons_slot``, when given, is the
            slot whose message is consumed first. Returns the digest's
            component substitution and the overflow."""
            L = par.shape[0]
            cnt, psrc = states["net_cnt"][par], states["net_src"][par]
            pdst, pmsg = states["net_dst"][par], states["net_msg"][par]
            esrc = torch.zeros((L, K), dtype=torch.int64, device=dev)
            edst, eold, enew = (torch.zeros_like(esrc) for _ in range(3))
            emsg = torch.zeros((L, K, W), dtype=torch.int64, device=dev)
            eused = torch.zeros((L, K), dtype=torch.bool, device=dev)
            empties = (cnt == 0).sum(dim=1)
            if cons_slot is not None:
                c0 = pick(cnt, cons_slot)
                esrc[:, 0], edst[:, 0] = pick(psrc, cons_slot), pick(pdst, cons_slot)
                emsg[:, 0] = pick(pmsg, cons_slot)
                eold[:, 0], enew[:, 0], eused[:, 0] = c0, (c0 - 1) & U32, True
                empties = empties + (c0 == 1).to(torch.int64)
            ov = torch.zeros(L, dtype=torch.bool, device=dev)
            slots = torch.arange(K, device=dev)
            # Each send's envelope among the parent's active ones, for all
            # sends at once: (L, S, E).
            pmatch = ((psrc == src[:, None])[:, None] & (pdst[:, None] == sends[:, :, :1])
                      & (pmsg[:, None] == sends[:, :, None, 1:]).all(dim=3)
                      & (cnt > 0)[:, None])
            pfounds = pmatch.any(dim=2)
            pcnts = cnt.gather(1, _first_true(pmatch))
            for si in range(S):
                dst, msg = sends[:, si, 0], sends[:, si, 1:]
                active = dst != codec.SEND_NONE
                wmatch = (eused & (esrc == src[:, None]) & (edst == dst[:, None])
                          & (emsg == msg[:, None, :]).all(dim=2))
                wfound = wmatch.any(dim=1)
                wj = _first_true(wmatch)
                pfound, pcnt = pfounds[:, si], pcnts[:, si]
                cur = torch.where(wfound, pick(enew, wj), torch.where(pfound, pcnt, 0))
                old0 = torch.where(pfound, pcnt, 0)
                exists = cur > 0
                has_empty = empties > 0
                add = (~exists).to(torch.int64) if dup else 1
                ok = active & (exists | has_empty)
                ncnt = cur + torch.where(ok, add, 0)
                j = torch.where(wfound, wj, _first_true(~eused))
                sel = (slots == j[:, None]) & ok[:, None]
                esrc = torch.where(sel, src[:, None], esrc)
                edst = torch.where(sel, dst[:, None], edst)
                emsg = torch.where(sel[:, :, None], msg[:, None, :], emsg)
                eold = torch.where(sel & ~wfound[:, None], old0[:, None], eold)
                enew = torch.where(sel, ncnt[:, None], enew)
                eused = eused | sel
                empties = empties - (ok & ~exists).to(torch.int64)
                ov = ov | (active & ~exists & ~has_empty)
            digest = digest_adjust(parent_digest[par], esrc, edst, emsg, eold, enew, eused)
            return [(N, *tagged_pair(digest, N), None)], ov

        def network_subs(par, cons_slot, shifted, sends, src):
            if ordered:
                init = None
                if cons_slot is not None:
                    ln = (states["flow_len"][par, cons_slot] - 1) & U32
                    init = (cons_slot, shifted, ln)
                return flows_apply(par, init, sends, src)
            return net_apply(par, cons_slot if not dup else None, sends, src)

        def hist_subs(hist, sends, src):
            if not hist_w:
                return []
            for si in range(S):
                dst, msg = sends[:, si, 0], sends[:, si, 1:]
                hn = codec.history_on_send(self, hist, src, dst, msg)
                hist = torch.where((dst != codec.SEND_NONE)[:, None], hn, hist)
            return [(hist_tag, *tagged_pair(hist, hist_tag), None)]

        def shifted_head(par, slot):
            q = states["flow_msg"][par, slot]
            return torch.cat([q[:, 1:], torch.zeros_like(q[:, :1])], dim=1)

        parts = []
        # Deliver: a lane a (parent, slot).
        par, slot = lanes_of(D), torch.arange(D, device=dev).repeat(F)
        present, env_src, env_dst, env_msg = self._env_at(states)
        actor = env_dst.clamp(0, N - 1)
        row = states["rows"][par, actor]
        row_new, sends, set_bits, cancel_bits, changed = self._select(
            [fn(actor, row, env_src, env_msg) for fn in codec.on_msg_branches(self)], actor)
        is_no_op = (~changed & (sends[:, :, 0] == codec.SEND_NONE).all(dim=1)
                    & (set_bits == 0) & (cancel_bits == 0))
        row_eff = torch.where(is_no_op[:, None], row, row_new)
        sends_eff = torch.where(is_no_op[:, None, None], codec.SEND_NONE, sends)
        set_eff = torch.where(is_no_op, 0, set_bits)
        cancel_eff = torch.where(is_no_op, 0, cancel_bits)
        t_new = (states["timers"][par, actor] | set_eff) & (~cancel_eff & U32)
        subs = [(actor, *actor_pair(actor, row_eff, t_new), None)]
        net, ov = network_subs(par, slot, shifted_head(par, slot) if ordered else None,
                               sends_eff, actor)
        subs += net
        if hist_w:
            hist = codec.history_on_deliver(self, states["hist"][par], env_src, env_dst,
                                            env_msg)
            subs += hist_subs(hist, sends_eff, actor)
        valid = (present & (env_dst < N) & ~self._crashed_rows(par, actor, states) & ~ov
                 & codec.packed_row_within_boundary(self, row_eff))
        if not ordered:
            valid = valid & ~is_no_op
        parts.append((*final_fp(par, subs), valid))

        if self._lossy_network:
            # Drop: the message at (parent, slot) lost.
            if ordered:
                ln = (states["flow_len"][par, slot] - 1) & U32
                subs = [(N + slot, *flow_pair(slot, shifted_head(par, slot), ln), None)]
            else:
                c0 = states["net_cnt"][par, slot]
                new_cnt = torch.zeros_like(c0) if dup else (c0 - 1) & U32
                digest = digest_adjust(parent_digest[par], env_src[:, None], env_dst[:, None],
                                       env_msg[:, None], c0[:, None], new_cnt[:, None],
                                       torch.ones_like(present)[:, None])
                subs = [(N, *tagged_pair(digest, N), None)]
            parts.append((*final_fp(par, subs), present))

        if T:
            # Timeout: lane (parent, i·T + t) fires actor i's timer t.
            k = torch.arange(N * T, device=dev).repeat(F)
            par, t_actor, t_bit = lanes_of(N * T), k // T, k % T
            row = states["rows"][par, t_actor]
            row_new, sends, set_bits, cancel_bits, changed = self._select(
                [fn(t_actor, row, t_bit) for fn in codec.on_timeout_branches(self)], t_actor)
            renews_only = (~changed & (sends[:, :, 0] == codec.SEND_NONE).all(dim=1)
                           & (cancel_bits == 0) & (set_bits == _bit(t_bit)))
            timers = states["timers"][par, t_actor]
            timer_set = ((timers >> t_bit) & 1) == 1
            t_new = ((timers & (~_bit(t_bit) & U32)) | set_bits) & (~cancel_bits & U32)
            subs = [(t_actor, *actor_pair(t_actor, row_new, t_new), None)]
            net, ov = network_subs(par, None, None, sends, t_actor)
            subs += net
            if hist_w:
                subs += hist_subs(states["hist"][par], sends, t_actor)
            valid = (timer_set & ~renews_only & ~ov
                     & codec.packed_row_within_boundary(self, row_new))
            parts.append((*final_fp(par, subs), valid))

        if self._max_crashes:
            # Crash: lane (parent, i) crashes actor i (its timers cleared).
            i = torch.arange(N, device=dev).repeat(F)
            par = lanes_of(N)
            subs = [(i, *actor_pair(i, states["rows"][par, i], torch.zeros_like(i)), None)]
            crashed = states["crashed"]
            valid = ((crashed.sum(dim=1) < self._max_crashes)[par]
                     & (crashed[par, i] == 0))
            parts.append((*final_fp(par, subs), valid))

        return tuple(torch.cat([p[n].view(F, -1) for p in parts], dim=1) for n in range(3))

    def packed_expand(self, states):
        """All ``A`` candidates of each of F states, in the JAX package's
        action-id order (``_class_steps``): deliver ``D`` (a flow head or an
        envelope slot each), then drop ``D`` (lossy networks), then timeout
        ``N·T`` (lane ``i·T + t`` fires actor ``i``'s timer ``t``), then crash
        ``N``. Returns ``(cand, valid)`` with candidate leaves ``(F, A, ...)``
        and ``valid`` ``(F, A)``."""
        self._packed_check()
        F = states["rows"].shape[0]
        parts = [getattr(self, f"_expand_{name}")(states)
                 for name, _first, _n in self._class_bounds()]

        def grid(x):
            return x.reshape((F, -1) + x.shape[1:])

        if len(parts) == 1:  # deliver only: views, no copy of the candidates
            return {k: grid(v) for k, v in parts[0][0].items()}, grid(parts[0][1])
        cand = {k: torch.cat([grid(p[0][k]) for p in parts], dim=1) for k in states}
        valid = torch.cat([grid(p[1]) for p in parts], dim=1)
        return cand, valid

    def packed_conditions(self):
        self._packed_check()
        conds = self.codec.packed_conditions(self)
        # Codecs emit one condition per property as originally added;
        # ``retain_properties`` may have narrowed the model since.
        if len(conds) != self._properties_added:
            raise ValueError(
                "codec.packed_conditions must align with the model's "
                f"properties as added: {len(conds)} != {self._properties_added}"
            )
        return [conds[i] for i in self._property_codec_pos]

    def packed_within_boundary(self, states):
        return self.codec.packed_within_boundary(self, states)
