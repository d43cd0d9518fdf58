"""Named configurations: each a model at the JAX package's bench settings
and the ``spawn_gpu_bfs`` settings it runs with. ``chip_smoke.py`` and the
profiling scripts (``scripts/torch_profile.py``,
``scripts/torch_peak_memory.py``) take their models from here.

    from stateright_tpu_torch.configs import CONFIGS
    cfg = CONFIGS["abd3o"]
    checker = cfg.make().checker().spawn_gpu_bfs(**cfg.spawn).join()

``SWARM_CONFIGS`` are the JAX bench's swarm leg (``bench.py``'s
``_run_swarm_leg``): a model, its ``spawn_swarm`` settings (the seed
included) and the walk-step target, if any.

    cfg = SWARM_CONFIGS["skv483_deep"]
    checker = cfg.builder().spawn_swarm(**cfg.spawn).join()

``LIVENESS_CONFIGS`` are the JAX bench's liveness leg (``bench.py``'s
``_run_liveness_leg``), ``spawn_gpu_bfs`` with ``liveness="device"``: raft-3
check-live, the absence certificate over ``LevelDag`` (the bench's
``_LevelDag``), and the same DAG at a width that fills the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from .core.batch import BatchableModel
from .core.model import Model, Property


@dataclasses.dataclass(frozen=True)
class Config:
    name: str
    # Where the configuration comes from and what it is.
    source: str
    make: Callable
    spawn: Dict[str, int]
    # The exact count of an exhaustive check; None where the run stops at
    # a discovery (its count at the exit depends on wave boundaries).
    unique: Optional[int]


def _two_phase_commit_8():
    from .models.two_phase_commit import TwoPhaseSys

    return TwoPhaseSys(8)


def _paxos3():
    from .models.paxos import PaxosModelCfg

    return PaxosModelCfg(3, 3, envelope_capacity=24).into_model()


def _abd3o():
    from .actor.network import Network
    from .models.linearizable_register import AbdModelCfg

    return AbdModelCfg(3, 2, network=Network.new_ordered(), envelope_capacity=12,
                       flow_capacity=2).into_model()


def _raft5_ttc():
    from .models.raft import RaftModelCfg

    model = RaftModelCfg(server_count=5, max_term=1, lossy=True).into_model()
    return model.retain_properties("stable leader")


def _skv4x4():
    from .models.sharded_kv import ShardedKv

    return ShardedKv(4, 4, 3, guarded=True)


def _raft4():
    from .models.raft import RaftModelCfg

    return RaftModelCfg(server_count=4, max_term=1, lossy=True).into_model()


CONFIGS = {c.name: c for c in (
    Config("2pc8", "two-phase commit, 8 resource managers: the JAX package's scale check",
           _two_phase_commit_8,
           dict(frontier_capacity=8192, table_capacity=1 << 20, drain_log_factor=48),
           1_745_408),
    Config("paxos3", "paxos check 3: 3 clients, 3 servers, 24 envelope slots "
           "(bench.py:164-176)", _paxos3,
           dict(frontier_capacity=2048, table_capacity=1 << 21, drain_log_factor=32),
           1_194_428),
    Config("abd3o", "linearizable-register check 3 ordered: ABD, 3 clients, 2 servers, "
           "FIFO flows of depth 2 (bench.py:199-209)", _abd3o,
           dict(frontier_capacity=1 << 11, table_capacity=1 << 17), 46_516),
    Config("raft5_ttc", "raft, 5 servers, lossy, only 'stable leader': the time to its "
           "counterexample (bench.py:234-245)", _raft5_ttc,
           dict(frontier_capacity=1 << 11, table_capacity=1 << 21), None),
    Config("raft4", "raft, 4 servers, lossy, every property: the full space "
           "(tests/test_raft5.py:71-80)", _raft4,
           dict(frontier_capacity=1 << 11, table_capacity=1 << 16), 24_545),
    Config("skv4x4", "fixed sharded KV, 4 shards, 4 keys, versions <= 3; bench.py:2420 "
           "ShardedKv(4, 8, 3) cut to 4 keys for an exhaustive check", _skv4x4,
           dict(frontier_capacity=8192, table_capacity=1 << 25, drain_log_factor=128),
           16_777_216),
)}


@dataclasses.dataclass(frozen=True)
class SwarmConfig:
    name: str
    source: str
    make: Callable
    # ``spawn_swarm``'s settings, the seed included.
    spawn: Dict[str, int]
    # ``target_state_count`` (walk steps), or None: the run ends at its
    # discoveries.
    target: Optional[int]

    def builder(self):
        b = self.make().checker()
        return b.target_state_count(self.target) if self.target is not None else b


def _skv483_deep():
    from .models.sharded_kv import ShardedKv

    return ShardedKv(4, 8, 3, retain=("no total tear",))


def _raft3_live():
    from .models.raft import RaftModelCfg

    model = RaftModelCfg(server_count=3, max_term=1, lossy=True).into_model()
    return model.retain_properties("stable leader")


def _two_phase_commit_3():
    from .models.two_phase_commit import TwoPhaseSys

    return TwoPhaseSys(3)


SWARM_CONFIGS = {c.name: c for c in (
    SwarmConfig("skv483_deep", "sharded KV, 4 shards, 8 keys, versions <= 3 (~10^14 "
                "states), only 'no total tear': the deep violation hunt "
                "(bench.py:2419-2447)", _skv483_deep,
                dict(seed=3, lanes=1024, wave_steps=128, max_trace_len=128,
                     sample_capacity=1 << 17, sample_stride=8), None),
    SwarmConfig("raft3_live", "raft, 3 servers, lossy, max_term 1, only 'stable leader': "
                "check-live by walks (bench.py:2308-2313)", _raft3_live,
                dict(seed=7, lanes=512, wave_steps=64, max_trace_len=128,
                     sample_capacity=1 << 15, sample_stride=8), None),
    SwarmConfig("2pc3_witness", "two-phase commit, 3 resource managers: the hunt for "
                "both 'sometimes' witnesses, polled and preempted once both land "
                "(bench.py:2362-2376)", _two_phase_commit_3,
                dict(seed=11, lanes=512, wave_steps=64, max_trace_len=64,
                     sample_capacity=1 << 15, sample_stride=4), 50_000_000),
)}


# -- the liveness leg (bench.py's _run_liveness_leg) ------------------------------


class LevelDag(Model, BatchableModel):
    """The absence-certification workload of the JAX bench
    (``bench.py:2010-2100``, ``_LevelDag``): a wide, shallow DAG of
    ``levels + 1`` levels, each of at most ``2 ** width_bits`` values;
    every maximal path ends at a terminal ``level == levels`` state where
    the ``eventually "done"`` condition finally holds. No cycle and no
    condition-false terminal, so no counterexample: certifying absence
    costs the whole condition-false region on the host post-pass, and the
    trim's rounds on the device.

    Host states are actor-shaped on purpose, a (level, bit-tuple,
    message-frozenset) record, so the host pass pays the construction and
    hashing cost real models pay; the packed side is one u32 word,
    ``level * W + value`` (``pack_state`` strips the garnish), so both
    explore the same region. The bench's class fixes ``width_bits=13``,
    ``levels=20``: 73,727 states, 65,535 condition-false ones, 114,686
    condition-false edges."""

    def __init__(self, width_bits: int = 13, levels: int = 20):
        self.WB = width_bits
        self.W = 1 << width_bits
        self.L = levels

    def _mk(self, level, value):
        bits = tuple((value >> i) & 1 for i in range(self.WB))
        msgs = frozenset((i, b) for i, b in enumerate(bits) if b)
        return (level, bits, msgs)

    def _value(self, state):
        return sum(b << i for i, b in enumerate(state[1]))

    def init_states(self):
        return [self._mk(0, 0)]

    def actions(self, state, actions):
        if state[0] < self.L:
            actions.extend((0, 1))

    def next_state(self, state, action):
        level = state[0]
        value = (2 * self._value(state) + action + level) % self.W
        return self._mk(level + 1, value)

    def properties(self):
        return [Property.eventually("done", lambda _m, s: s[0] == self.L)]

    # -- packed protocol ---------------------------------------------------

    def packed_action_count(self):
        return 2

    def packed_init_states(self, device="cpu"):
        return {"s": torch.zeros(1, dtype=torch.int64, device=device)}

    def packed_expand(self, states):
        s = states["s"]
        level, value = s // self.W, s % self.W
        valid = (level < self.L)[:, None].expand(-1, 2)
        action = torch.arange(2, dtype=torch.int64, device=s.device)
        nxt = (level + 1)[:, None] * self.W + (
            2 * value[:, None] + action + level[:, None]) % self.W
        return {"s": torch.where(valid, nxt, s[:, None])}, valid

    def packed_conditions(self):
        return [lambda st: (st["s"] // self.W) == self.L]

    def pack_state(self, host_state):
        return {"s": torch.tensor(host_state[0] * self.W + self._value(host_state),
                                  dtype=torch.int64)}

    def unpack_state(self, packed):
        s = int(packed["s"])
        return self._mk(s // self.W, s % self.W)


def _level_dag_2p20():
    return LevelDag(width_bits=20, levels=20)


LIVENESS_CONFIGS = {c.name: c for c in (
    Config("raft3_check_live", "raft, 3 servers, lossy, max_term 1, only 'stable "
           "leader': check-live with liveness='device' (bench.py:2130-2143)", _raft3_live,
           dict(frontier_capacity=1 << 10, table_capacity=1 << 14, liveness="device"), None),
    Config("level_dag_absence", "bench.py's _LevelDag, W = 2^13, L = 20: the absence "
           "certificate (bench.py:2010-2100, :2163-2175)", LevelDag,
           dict(frontier_capacity=1 << 12, table_capacity=1 << 17, liveness="device"),
           73_727),
    Config("level_dag_2p20", "bench.py's _LevelDag widened to W = 2^20, L = 20: the "
           "absence certificate at a size that fills the card's waves", _level_dag_2p20,
           dict(frontier_capacity=1 << 16, table_capacity=1 << 23, liveness="device"),
           2_097_151),
)}
