"""Labeled conformance corpora: generated histories and traces with
known ground truth.

The port of the JAX package's ``conformance/corpus.py``: every
``random.Random`` draw happens in the same order, so one seed gives the
same records, byte for byte. The port's models have no ``packed_step``; a
trace step is ``packed_expand`` of a one-lane batch and the chosen
candidate (the walker's step, ``checker/gpu_simulation.py``), whose valid
mask equals the JAX ``packed_step``'s everywhere.

Bench legs and parity tests need uploads whose verdicts are *knowable*:

- **histories** come out of an actual concurrent execution simulator —
  ops commit atomically at their return event, so every ``clean``
  history is linearizable by construction (the witness order is the
  commit order); ``random`` histories draw returns uniformly instead
  (a mix of consistent and violating, labeled only by the host
  oracle); ``invalid`` histories take a clean skeleton and inject the
  two client-bug edges the host testers latch on (double invoke,
  orphan return). Any history may leave ops in flight.
- **traces** are random walks over the packed model (uniform over the
  *valid* actions at each step — by construction a behaviour of the
  model); ``mutate_trace`` replants one recorded action with an action
  whose guard is provably false at that point, yielding a trace whose
  first divergence index is known exactly.

Labels ride the wire frames' free-form ``meta`` field (``expect`` /
``divergence_index``), which the parity suite reads back. Everything is
seeded — a corpus is reproducible from its generator seed.
"""

from __future__ import annotations

import random
from typing import List, Optional, Sequence, Tuple

from ..core.batch import map_leaves

from ..semantics.register import Register
from ..semantics.vec import VecSpec

_ALPHABET = "abcdef"


def _random_op(rng: random.Random, spec: str) -> Tuple[str, Optional[str]]:
    if spec == "register":
        if rng.random() < 0.5:
            return "Write", rng.choice(_ALPHABET)
        return "Read", None
    roll = rng.random()
    if roll < 0.45:
        return "Push", rng.choice(_ALPHABET)
    if roll < 0.85:
        return "Pop", None
    return "Len", None


def _commit_ret(spec_obj, tag: str, value):
    """Executes one op atomically on the live spec object -> the decoded
    return payload (the wire codec's normalized form)."""
    if tag == "Write":
        spec_obj.invoke(("Write", value))
        return None
    if tag == "Read":
        return spec_obj.invoke(("Read",))[1]
    if tag == "Push":
        spec_obj.invoke(("Push", value))
        return None
    if tag == "Pop":
        ret = spec_obj.invoke(("Pop",))
        return ("none",) if ret[1] is None else ("some", ret[1][1])
    return spec_obj.invoke(("Len",))[1]


def _random_ret(rng: random.Random, tag: str):
    if tag in ("Write", "Push"):
        return None
    if tag == "Read":
        return rng.choice(_ALPHABET)
    if tag == "Pop":
        if rng.random() < 0.4:
            return ("none",)
        return ("some", rng.choice(_ALPHABET))
    return rng.randrange(0, 5)


def random_history(
    rng: random.Random,
    spec: str = "register",
    semantics: str = "linearizability",
    threads: int = 2,
    ops_per_thread: int = 2,
    mode: str = "clean",
    default: str = "a",
    inflight_prob: float = 0.25,
    rec_id: str = "h0",
) -> dict:
    """One decoded history record (``wire.decode_lines`` output shape)
    with a ``meta.expect`` label: ``clean`` -> consistent by
    construction; ``random`` -> unlabeled (oracle decides); ``invalid``
    -> invalid history (both testers report inconsistent)."""
    assert mode in ("clean", "random", "invalid")
    spec_obj = Register(default) if spec == "register" else VecSpec()
    remaining = {t: ops_per_thread for t in range(threads)}
    inflight = {}  # tid -> (tag, value)
    events = []
    while any(remaining.values()) or inflight:
        can_invoke = [
            t for t, n in remaining.items() if n > 0 and t not in inflight
        ]
        can_return = list(inflight)
        if can_invoke and (not can_return or rng.random() < 0.5):
            t = rng.choice(can_invoke)
            tag, value = _random_op(rng, spec)
            inflight[t] = (tag, value)
            remaining[t] -= 1
            events.append(("invoke", t, tag, value))
        else:
            t = rng.choice(can_return)
            tag, value = inflight.pop(t)
            # Leave a tail op in flight sometimes (the edge the packed
            # codecs must model: generated returns are unconstrained).
            if (
                not remaining[t] and rng.random() < inflight_prob
                and mode != "invalid"
            ):
                inflight[t] = (tag, value)
                del inflight[t]
                continue  # drop the return: op stays in flight forever
            if mode == "random":
                ret = _random_ret(rng, tag)
            else:
                ret = _commit_ret(spec_obj, tag, value)
            events.append(("return", t, tag, ret))
    if mode == "invalid":
        # Inject one of the two latching client bugs at a random point.
        if rng.random() < 0.5 and any(
            e[0] == "invoke" for e in events
        ):
            # Double invoke: re-invoke a thread right after its invoke.
            idx = rng.choice(
                [i for i, e in enumerate(events) if e[0] == "invoke"]
            )
            t = events[idx][1]
            tag, value = _random_op(rng, spec)
            events.insert(idx + 1, ("invoke", t, tag, value))
        else:
            # Orphan return: a return for a thread with nothing in
            # flight, at the very start.
            t = rng.randrange(threads)
            events.insert(0, ("return", t, None, None))
    meta = {"expect": "consistent" if mode == "clean" else mode}
    return {
        "kind": "history",
        "id": rec_id,
        "semantics": semantics,
        "spec": spec,
        "default": default if spec == "register" else None,
        "events": events,
        "meta": meta,
    }


# -- traces -----------------------------------------------------------------


def _init_lane(model, init: int):
    """Initial state ``init`` as a one-lane batch (host tensors)."""
    return map_leaves(lambda x: x[init : init + 1], model.packed_init_states())


def _expand(model, state):
    """``(candidates, valid action ids)`` of a one-lane batch."""
    cand, valid = model.packed_expand(state)
    return cand, [int(a) for a in valid[0].nonzero().flatten().tolist()]


def _take(cand, a: int):
    """The candidate of action ``a`` as a one-lane batch."""
    return map_leaves(lambda c: c[:, a], cand)


def random_walk_trace(
    model, rng: random.Random, steps: int, init: int = 0,
    rec_id: str = "t0", model_name: str = "", model_args: Optional[dict] = None,
) -> dict:
    """One decoded trace record: a seeded uniform random walk over the
    model's valid actions — a behaviour of the model by construction
    (``meta.expect = "clean"``). Stops early at terminal states, before
    drawing."""
    state = _init_lane(model, init)
    actions: List[int] = []
    for _ in range(steps):
        cand, valid = _expand(model, state)
        if not valid:
            break
        a = rng.choice(valid)
        actions.append(a)
        state = _take(cand, a)
    if not actions:
        raise ValueError("initial state is terminal; no trace to record")
    return {
        "kind": "trace",
        "id": rec_id,
        "model": model_name,
        "model_args": dict(model_args or {}),
        "init": init,
        "actions": actions,
        "meta": {"expect": "clean"},
    }


def mutate_trace(model, rng: random.Random, rec: dict) -> Optional[dict]:
    """A divergent twin of one clean trace: one recorded action is
    replaced by an action whose guard is false at that point, so the
    first divergence index is known exactly (``meta.divergence_index``).
    Returns None when every action is enabled everywhere along the
    trace (no mutation site exists)."""
    A = model.packed_action_count()
    state = _init_lane(model, rec["init"])
    sites: List[Tuple[int, List[int]]] = []
    for i, a in enumerate(rec["actions"]):
        cand, valid_ids = _expand(model, state)
        valid = set(valid_ids)
        invalid = [x for x in range(A) if x not in valid]
        if invalid:
            sites.append((i, invalid))
        state = _take(cand, a)
    if not sites:
        return None
    k, invalid = sites[rng.randrange(len(sites))]
    actions = list(rec["actions"])
    offending = rng.choice(invalid)
    actions[k] = offending
    return {
        **rec,
        "id": rec["id"] + "-div",
        "actions": actions,
        "meta": {
            "expect": "divergent",
            "divergence_index": k,
            "offending_action": offending,
        },
    }


def generate_corpus(
    seed: int,
    model_specs: Sequence[Tuple[str, dict, object]] = (),
    traces_per_model: int = 4,
    mutated_per_model: int = 2,
    trace_steps: int = 12,
    histories: int = 12,
    history_shapes: Sequence[Tuple[str, str, int, int]] = (
        ("register", "linearizability", 2, 2),
        ("register", "sequential", 2, 2),
        ("vec", "linearizability", 2, 2),
    ),
) -> List[dict]:
    """A labeled mixed corpus: clean + mutated traces per model config,
    clean/random/invalid histories per shape. ``model_specs`` is
    ``(zoo_name, args, model_instance)`` triples. Deterministic in
    ``seed``."""
    rng = random.Random(seed)
    out: List[dict] = []
    for name, args, model in model_specs:
        clean = []
        for i in range(traces_per_model):
            rec = random_walk_trace(
                model, rng, trace_steps, rec_id=f"{name}-t{i}",
                model_name=name, model_args=args,
            )
            clean.append(rec)
            out.append(rec)
        made = 0
        for rec in clean:
            if made >= mutated_per_model:
                break
            mut = mutate_trace(model, rng, rec)
            if mut is not None:
                out.append(mut)
                made += 1
    modes = ["clean", "random", "invalid"]
    for i in range(histories):
        spec, semantics, C, O = history_shapes[i % len(history_shapes)]
        mode = modes[i % len(modes)]
        out.append(random_history(
            rng, spec=spec, semantics=semantics, threads=C,
            ops_per_thread=O, mode=mode,
            rec_id=f"{spec[:3]}-{semantics[:3]}-h{i}",
        ))
    return out
