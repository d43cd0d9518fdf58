"""Packed actor systems: ``ActorModel`` transitions batched in torch.

The port of the JAX package's ``actor/packed.py``. The host ``ActorModel``
(``actor/model.py``) enumerates data-dependent action sets and runs
arbitrary Python actor callbacks (the reference's design,
``src/actor/model.rs:214-649``). ``PackedActorModel`` is its fixed-width
twin, written batched over a leading lane axis:

- **actor rows**: per-actor state packs into an ``(N, R)`` u32 matrix;
- **network table**: an unordered network is a bounded ``(E,)``-slot
  envelope table (src, dst, msg words, count). Identical envelope multisets
  fingerprint identically because the fingerprint reduces the table to an
  order-insensitive multiset digest: no per-transition sort;
- **timers**: one bitmask word per actor;
- **dense actions**: one Deliver id per envelope slot, each with its guard;
- **auxiliary history**: codecs with ``history_width > 0`` carry a packed
  history vector updated by the batched twins of ``record_msg_in`` and
  ``record_msg_out`` (see ``semantics/packed_linearizability.py``);
- **actor callbacks**: each actor type supplies a batched ``on_msg``
  through an ``ActorPackedCodec``. The JAX package dispatches with
  ``lax.switch``, which under ``vmap`` runs every branch on every lane; so
  does this port: every actor type's branch runs over all lanes and
  ``torch.where`` selects.

The transition semantics mirror the host model exactly (no-op pruning,
deliver-before-send network effects, the lowest free slot for a new
envelope), so packed and host checkers agree on exact state counts, and
the port's candidates equal the JAX package's lane for lane.

Not ported yet, and refused by name with a ``ValueError``: ordered
networks, lossy networks (the drop class), timers (the timeout class),
crash faults (ROADMAP Queue 1 #4), symmetry and the fingerprint-only
expansion ``packed_expand_fps``/``packed_take`` (Queue 1 #6). Nothing
falls back to anything.

Everything the device checker runs here is capturable in a CUDA Graph: no
value is read back, no shape depends on data, and the constant tables
(hash coefficients, component seeds) are made once per device before any
capture (``ops/fingerprint.py``).

u32 values ride in ``int64``, as everywhere in the port.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from ..core.batch import BatchableModel
from ..ops.fingerprint import U32, combine_pairs, hash_rows, multiset_digest
from .actor import Id
from .model import ActorModel
from .model_state import ActorModelState
from .network import (
    Envelope,
    ORDERED,
    UNORDERED_DUPLICATING,
    UNORDERED_NONDUPLICATING,
)
from .timers import Timers

_NET_KEYS = ("net_src", "net_dst", "net_msg", "net_cnt")


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
    """

    SEND_NONE = 0xFFFFFFFF

    msg_width: int
    state_width: int
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
        return []

    # -- batched model hooks --------------------------------------------------

    def packed_conditions(self, model) -> List[Callable]:
        raise NotImplementedError

    def packed_within_boundary(self, model, states):
        rows = states["rows"]
        return torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)


def _refuse(what: str, item: str):
    raise ValueError(
        f"{what} is not ported to stateright_tpu_torch yet (ROADMAP.md "
        f"{item}); the JAX package stateright_tpu runs it"
    )


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 when none is (as
    ``jnp.argmax`` of a bool vector)."""
    return mask.to(torch.uint8).argmax(dim=-1)


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

    def with_envelope_capacity(self, capacity: int) -> "PackedActorModel":
        """Sets the network table's slot count. It must bound the reachable
        distinct-envelope count: overflowing transitions are pruned, which
        the exact-count parity tests surface as a mismatch."""
        self.envelope_capacity = capacity
        return self

    # -- validation -----------------------------------------------------------

    def _packed_check(self):
        if self.init_history is not None and not self.codec.history_width:
            raise NotImplementedError(
                "this codec does not pack auxiliary history (declare "
                "history_width and the history hooks to stage it on device)"
            )
        if self._init_network.kind == ORDERED:
            _refuse("an ordered network (FIFO flows)", "Queue 1 #4")
        if self._lossy_network:
            _refuse("a lossy network (the drop action class)", "Queue 1 #4")
        if self._max_crashes:
            _refuse("crash faults (max_crashes)", "Queue 1 #4")
        if self.codec.timer_values:
            _refuse("actor timers (the timeout action class)", "Queue 1 #4")

    # -- static shape helpers -------------------------------------------------

    @property
    def _N(self) -> int:
        return len(self.actors_list)

    @property
    def _E(self) -> int:
        return self.envelope_capacity

    @property
    def _dup(self) -> bool:
        return self._init_network.kind == UNORDERED_DUPLICATING

    def packed_action_count(self) -> int:
        self._packed_check()
        return self._E

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
        if self._init_network.kind == UNORDERED_NONDUPLICATING:
            items = list(sys_state.network.data.items())
        else:
            items = [(env, 1) for env in sys_state.network.data]
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
        out = {
            "rows": rows,
            "timers": timers,
            "net_src": net_src,
            "net_dst": net_dst,
            "net_msg": net_msg,
            "net_cnt": net_cnt,
        }
        if codec.history_width:
            hist = np.asarray(codec.pack_history(sys_state.history), np.uint32)
            if hist.shape != (codec.history_width,):
                raise ValueError(
                    f"pack_history returned shape {hist.shape}; expected "
                    f"({codec.history_width},)"
                )
            out["hist"] = hist
        return {k: torch.from_numpy(v.astype(np.int64)) for k, v in out.items()}

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
        network = self._init_network.copy()
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
        return ActorModelState(
            actor_states=actor_states,
            network=network,
            timers_set=timers_set,
            crashed=[False] * self._N,
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

    def packed_fingerprint_view(self, states):
        """The fingerprintable view of a batch: the envelope table reduced to
        its order-insensitive multiset digest (``net_digest``, ``(N, 4)``),
        the other leaves as they are."""
        self._packed_check()
        out = {k: v for k, v in states.items() if k not in _NET_KEYS}
        out["net_digest"] = multiset_digest(self._net_rows(states), states["net_cnt"] > 0)
        return out

    def packed_component_pairs(self, states):
        """Component-hash pairs of a batch: ``(his, los)``, each ``(N, C)``,
        one pair per component in a fixed order — the actors ``0..N-1``
        (actor row ‖ timer word), the network ``N`` (the multiset digest,
        hashed as one row), and the history ``N + 1`` when the codec has
        one — each seeded by its tag."""
        self._packed_check()
        N = self._N
        rows_t = torch.cat([states["rows"], states["timers"][..., None]], dim=-1)
        ah, al = hash_rows(rows_t, range(N))
        digest = multiset_digest(self._net_rows(states), states["net_cnt"] > 0)
        nh, nl = hash_rows(digest[..., None, :], (N,))
        his, los = [ah, nh], [al, nl]
        if self.codec.history_width:
            hh, hl = hash_rows(states["hist"][..., None, :], (N + 1,))
            his.append(hh)
            los.append(hl)
        return torch.cat(his, dim=-1), torch.cat(los, dim=-1)

    def packed_fingerprint(self, states):
        """Component-hash fingerprints (see ``packed_component_pairs``), each
        ``(N,)``: the same view semantics as ``packed_fingerprint_view``
        (the network hashed order-insensitively)."""
        return combine_pairs(*self.packed_component_pairs(states))

    def packed_comphash_layout(self) -> Dict[str, Any]:
        """What the fused wave's component-hash kernel
        (``csrc/fused_wave.cu::fw_comphash_keys``) needs to compute
        ``packed_fingerprint``: the leaf of each component group, each
        group's tag base, and the widths."""
        self._packed_check()
        return {
            "actors": ("rows", "timers"),
            "network": _NET_KEYS,
            "history": "hist" if self.codec.history_width else None,
            "actor_tag": 0,
            "network_tag": self._N,
            "history_tag": self._N + 1,
            "N": self._N,
            "R": self.codec.state_width,
            "E": self._E,
            "W": self.codec.msg_width,
            "H": self.codec.history_width,
        }

    # -- refused by name ---------------------------------------------------------

    def packed_symmetry(self):
        _refuse("symmetry reduction of packed actor systems", "Queue 1 #6")

    def packed_expand_fps(self, states):
        _refuse("the fingerprint-only expansion (packed_expand_fps)", "Queue 1 #6")

    def packed_take(self, states, action_id):
        _refuse("the single-child materializer (packed_take)", "Queue 1 #6")

    # -- batched transition --------------------------------------------------------

    def _net_send(self, state, src, dst, msg, active):
        """One network send per lane (host ``Network.send``): a duplicating
        network keeps one copy, a non-duplicating one counts. A new envelope
        takes the lowest free slot, as the JAX package's ``argmax`` does
        (deliver action ids are slot indices, so the slot decides parents
        and paths). Returns (state, overflow)."""
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

    def _apply_callback(self, state, actor, row_new, sends, set_bits, cancel_bits):
        """Applies a callback's effects per lane: the row write, the timer
        bookkeeping (sets, then cancels), then the sends in command order,
        each followed by the history's ``record_msg_out`` twin. Returns
        (state, overflow)."""
        codec = self.codec
        state = dict(state)
        own = torch.arange(self._N, device=actor.device) == actor[:, None]  # (L, N)
        state["rows"] = torch.where(own[:, :, None], row_new[:, None, :], state["rows"])
        t = (state["timers"] * own).sum(dim=1)
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

    def packed_expand(self, states):
        """All ``A = E`` Deliver candidates of each of F states, lane
        ``(f, e)`` delivering envelope slot ``e`` (the JAX package's
        ``packed_expand`` with the deliver class only): ``(cand, valid)``
        with candidate leaves ``(F, E, ...)`` and ``valid`` ``(F, E)``."""
        self._packed_check()
        codec = self.codec
        N, E, W = self._N, self._E, codec.msg_width
        F = states["rows"].shape[0]
        L = F * E
        dev = states["rows"].device
        st = {
            k: v[:, None].expand((F, E) + v.shape[1:]).reshape((L,) + v.shape[1:])
            for k, v in states.items()
        }
        present = states["net_cnt"].reshape(L) > 0
        env_src = states["net_src"].reshape(L)
        env_dst = states["net_dst"].reshape(L)
        env_msg = states["net_msg"].reshape(L, W)
        actor = env_dst.clamp(0, N - 1)
        row = st["rows"].gather(
            1, actor[:, None, None].expand(L, 1, codec.state_width)
        )[:, 0]
        outs = [fn(actor, row, env_src, env_msg) for fn in codec.on_msg_branches(self)]
        row_new, sends, set_bits, cancel_bits, changed = outs[0]
        if len(outs) > 1:
            kind = self._type_of(actor)
            for k, o in enumerate(outs[1:], start=1):
                sel = kind == k
                row_new = torch.where(sel[:, None], o[0], row_new)
                sends = torch.where(sel[:, None, None], o[1], sends)
                set_bits = torch.where(sel, o[2], set_bits)
                cancel_bits = torch.where(sel, o[3], cancel_bits)
                changed = torch.where(sel, o[4], changed)
        no_sends = (sends[:, :, 0] == codec.SEND_NONE).all(dim=1)
        is_no_op = ~changed & no_sends & (set_bits == 0) & (cancel_bits == 0)

        out = dict(st)
        if codec.history_width:
            out["hist"] = codec.history_on_deliver(self, st["hist"], env_src, env_dst,
                                                   env_msg)
        if not self._dup:
            slot = torch.arange(E, device=dev).repeat(F)
            consumed = torch.arange(E, device=dev) == slot[:, None]
            out["net_cnt"] = (st["net_cnt"] - consumed.to(torch.int64)) & U32
        out, ov = self._apply_callback(
            out,
            actor,
            torch.where(is_no_op[:, None], row, row_new),
            torch.where(is_no_op[:, None, None], codec.SEND_NONE, sends),
            torch.where(is_no_op, 0, set_bits),
            torch.where(is_no_op, 0, cancel_bits),
        )
        valid = present & (env_dst < N) & ~is_no_op & ~ov
        cand = {k: v.reshape((F, E) + v.shape[1:]) for k, v in out.items()}
        return cand, valid.reshape(F, E)

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
