"""Conformance wire format v1: recorded executions as JSONL frames.

The port's copy of the JAX package's ``conformance/wire.py`` (it imports
neither): the ingestion leg of the conformance plane. Users upload what their *real* system did — operation histories from
client libraries and event traces from deployment logs — and the
service audits them against the reference semantics / the packed model.
Uploads are hostile by construction (torn writes, truncated files,
version skew, hand-edited JSON), so every frame is validated and every
rejection is an **honest refusal** with a line number and a reason —
never a silent drop, never a crash. A refused frame still gets a
verdict (``"refused"``) so batch accounting always sums to the upload.

One JSON object per line. Two frame kinds share a common envelope::

    {"v": 1, "kind": "history", "id": "h0",
     "semantics": "linearizability" | "sequential",
     "spec": {"type": "register", "default": "a"} | {"type": "vec"},
     "events": [["invoke", 0, ["Write", "b"]], ["return", 0, ["WriteOk"]],
                ["invoke", 1, ["Read"]], ["return", 1, ["ReadOk", "b"]]],
     "meta": {...}}

    {"v": 1, "kind": "trace", "id": "t0",
     "model": "2pc", "model_args": {"rm_count": 3},
     "init": 0, "actions": [3, 1, 4, 1], "meta": {...}}

- ops/returns are the tagged tuples of ``semantics/`` rendered as JSON
  arrays (``("Write", "b")`` -> ``["Write", "b"]``); register and vec
  payload values must be single-character strings (the packed codecs
  carry them as ``ord``/``chr`` words).
- ``meta`` is free-form and round-trips untouched — corpus generators
  label expectations there (``{"expect": "divergent",
  "divergence_index": 3}``) and the parity tests read them back.
- unknown *extra* keys are tolerated (forward compatibility); unknown
  ``v``/``kind``/``semantics``/``spec.type`` are refused (a frame we
  cannot interpret must not be guessed at).

``decode_lines`` is the one entry point; ``bucket_key`` assigns each
decoded record to a fixed-shape lane bucket (histories: exact
``(spec, semantics, threads, max ops/thread)``; traces: ``(model, args,
next-pow2 length)``) so a batch runs over identical static shapes.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

WIRE_VERSION = 1

HISTORY_SEMANTICS = ("linearizability", "sequential")
SPEC_TYPES = ("register", "vec")

# op tag -> the return tag a completed op must carry. A mismatched pair
# (e.g. Push answered by ReadOk) is not a *failing* history — it is a
# frame the reference semantics cannot even type, so it is refused at
# the wire rather than laundered into an "inconsistent" verdict.
_RET_TAG = {
    "Write": "WriteOk",
    "Read": "ReadOk",
    "Push": "PushOk",
    "Pop": "PopOk",
    "Len": "LenOk",
}
_REGISTER_OPS = ("Write", "Read")
_VEC_OPS = ("Push", "Pop", "Len")


class WireRefusal(ValueError):
    """One refused frame: ``line`` (1-based), ``reason``; raised only in
    strict mode — batch decoding collects these as records instead."""

    def __init__(self, line: int, reason: str, frame_id=None):
        super().__init__(f"line {line}: {reason}")
        self.line = line
        self.reason = reason
        self.frame_id = frame_id

    def as_record(self) -> dict:
        return {
            "line": self.line,
            "reason": self.reason,
            "id": self.frame_id,
        }


def _is_char(v) -> bool:
    return isinstance(v, str) and len(v) == 1


def _check_op(line: int, op, allowed, fid) -> Tuple[str, Optional[str]]:
    """Validates one op array -> (tag, value-or-None)."""
    if not isinstance(op, list) or not op or not isinstance(op[0], str):
        raise WireRefusal(line, f"malformed op {op!r}", fid)
    tag = op[0]
    if tag not in allowed:
        raise WireRefusal(
            line, f"op {tag!r} not valid for this spec", fid
        )
    if tag in ("Write", "Push"):
        if len(op) != 2 or not _is_char(op[1]):
            raise WireRefusal(
                line,
                f"{tag} payload must be one single-character string, "
                f"got {op[1:]!r}",
                fid,
            )
        return tag, op[1]
    if len(op) != 1:
        raise WireRefusal(line, f"{tag} takes no payload, got {op!r}", fid)
    return tag, None


def _check_ret(line: int, op_tag: str, ret, fid):
    """Validates one return array against its op -> normalized payload:
    Write/Push -> None; Read/Pop-Some -> char; Pop-None -> None marker;
    Len -> int."""
    want = _RET_TAG[op_tag]
    if not isinstance(ret, list) or not ret or ret[0] != want:
        raise WireRefusal(
            line, f"return for {op_tag} must be {want}, got {ret!r}", fid
        )
    if want in ("WriteOk", "PushOk"):
        if len(ret) != 1:
            raise WireRefusal(line, f"{want} takes no payload", fid)
        return None
    if want == "ReadOk":
        if len(ret) != 2 or not _is_char(ret[1]):
            raise WireRefusal(
                line, f"ReadOk payload must be one char, got {ret[1:]!r}",
                fid,
            )
        return ret[1]
    if want == "PopOk":
        # PopOk(None) | PopOk(("Some", v)) — JSON: ["PopOk", null] /
        # ["PopOk", ["Some", "v"]].
        if len(ret) != 2:
            raise WireRefusal(line, "PopOk needs exactly one payload", fid)
        if ret[1] is None:
            return ("none",)
        if (
            isinstance(ret[1], list) and len(ret[1]) == 2
            and ret[1][0] == "Some" and _is_char(ret[1][1])
        ):
            return ("some", ret[1][1])
        raise WireRefusal(
            line,
            f'PopOk payload must be null or ["Some", <char>], '
            f"got {ret[1]!r}",
            fid,
        )
    # LenOk
    if len(ret) != 2 or not isinstance(ret[1], int) or ret[1] < 0:
        raise WireRefusal(
            line, f"LenOk payload must be a non-negative int, got "
            f"{ret[1:]!r}", fid,
        )
    return ret[1]


def _decode_history(line: int, obj: dict) -> dict:
    fid = obj.get("id")
    semantics = obj.get("semantics")
    if semantics not in HISTORY_SEMANTICS:
        raise WireRefusal(
            line,
            f"unknown semantics {semantics!r} (expected one of "
            f"{list(HISTORY_SEMANTICS)})",
            fid,
        )
    spec = obj.get("spec")
    if not isinstance(spec, dict) or spec.get("type") not in SPEC_TYPES:
        raise WireRefusal(
            line,
            f"unknown spec {spec!r} (expected type in {list(SPEC_TYPES)})",
            fid,
        )
    spec_type = spec["type"]
    default = None
    if spec_type == "register":
        default = spec.get("default", "a")
        if not _is_char(default):
            raise WireRefusal(
                line,
                f"register default must be one single-character string, "
                f"got {default!r}",
                fid,
            )
    allowed = _REGISTER_OPS if spec_type == "register" else _VEC_OPS
    events_in = obj.get("events")
    if not isinstance(events_in, list):
        raise WireRefusal(line, "history frame is missing 'events'", fid)
    events = []
    in_flight: Dict[int, str] = {}
    for ev in events_in:
        if (
            not isinstance(ev, list) or len(ev) != 3
            or ev[0] not in ("invoke", "return")
            or not isinstance(ev[1], int) or ev[1] < 0
        ):
            raise WireRefusal(line, f"malformed event {ev!r}", fid)
        etype, tid, payload = ev
        if etype == "invoke":
            tag, value = _check_op(line, payload, allowed, fid)
            # NOTE: a double-invoke / orphan return is NOT refused here:
            # the host testers accept exactly one such event (marking
            # the history invalid forever) and refuse everything after
            # it ("Earlier history was invalid"), so the audit must see
            # the latching event to stay bit-identical — but events past
            # it are unreachable by the reference semantics (and
            # untypeable: the latch broke the op/return pairing), so
            # decoding stops there.
            if tid in in_flight:
                events.append(("invoke", tid, tag, value))
                break
            in_flight[tid] = tag
            events.append(("invoke", tid, tag, value))
        else:
            op_tag = in_flight.pop(tid, None)
            if op_tag is None:
                # Orphan return: latches exactly like a double invoke;
                # the payload is never interpreted.
                if not isinstance(payload, list) or not payload:
                    raise WireRefusal(
                        line, f"malformed return {payload!r}", fid
                    )
                events.append(("return", tid, None, None))
                break
            value = _check_ret(line, op_tag, payload, fid)
            events.append(("return", tid, op_tag, value))
    return {
        "kind": "history",
        "id": fid if isinstance(fid, str) else f"line{line}",
        "semantics": semantics,
        "spec": spec_type,
        "default": default,
        "events": events,
        "meta": obj.get("meta") or {},
    }


def _decode_trace(line: int, obj: dict) -> dict:
    fid = obj.get("id")
    model = obj.get("model")
    if not isinstance(model, str) or not model:
        raise WireRefusal(line, "trace frame is missing 'model'", fid)
    args = obj.get("model_args") or {}
    if not isinstance(args, dict):
        raise WireRefusal(
            line, f"model_args must be an object, got {args!r}", fid
        )
    init = obj.get("init", 0)
    if not isinstance(init, int) or init < 0:
        raise WireRefusal(
            line, f"init must be a non-negative int, got {init!r}", fid
        )
    actions = obj.get("actions")
    if (
        not isinstance(actions, list) or not actions
        or not all(isinstance(a, int) and a >= 0 for a in actions)
    ):
        raise WireRefusal(
            line, "actions must be a non-empty list of non-negative "
            "action ids", fid,
        )
    return {
        "kind": "trace",
        "id": fid if isinstance(fid, str) else f"line{line}",
        "model": model,
        "model_args": args,
        "init": init,
        "actions": list(actions),
        "meta": obj.get("meta") or {},
    }


def decode_frame(line: int, text: str) -> dict:
    """One wire line -> one decoded record; raises ``WireRefusal``."""
    try:
        obj = json.loads(text)
    except json.JSONDecodeError as e:
        # Torn frame: a killed writer tears the last line mid-object.
        raise WireRefusal(line, f"torn/unparseable frame: {e}") from e
    if not isinstance(obj, dict):
        raise WireRefusal(line, f"frame must be an object, got {obj!r}")
    fid = obj.get("id")
    v = obj.get("v")
    if v != WIRE_VERSION:
        raise WireRefusal(
            line, f"unknown wire version {v!r} (this decoder speaks "
            f"v{WIRE_VERSION})", fid,
        )
    kind = obj.get("kind")
    if kind == "history":
        return _decode_history(line, obj)
    if kind == "trace":
        return _decode_trace(line, obj)
    raise WireRefusal(
        line, f"unknown frame kind {kind!r} (expected 'history'/'trace')",
        fid,
    )


def decode_lines(
    lines: Sequence[str], strict: bool = False
) -> Tuple[List[dict], List[dict]]:
    """Decodes a whole upload -> ``(records, refusals)``.

    ``strict=True`` raises the first ``WireRefusal`` instead (the HTTP
    admission path: a 400 with the offending line beats accepting a
    batch whose accounting cannot match the upload)."""
    records: List[dict] = []
    refusals: List[dict] = []
    for n, text in enumerate(lines, start=1):
        text = text.strip()
        if not text:
            continue
        try:
            records.append(decode_frame(n, text))
        except WireRefusal as r:
            if strict:
                raise
            refusals.append(r.as_record())
    return records, refusals


def encode_record(rec: dict) -> str:
    """Decoded record -> one wire line (the corpus writers' inverse).
    Accepts both decoded records and raw frame dicts."""
    if "v" in rec:  # already a raw frame
        return json.dumps(rec, sort_keys=True)
    if rec["kind"] == "trace":
        frame = {
            "v": WIRE_VERSION, "kind": "trace", "id": rec["id"],
            "model": rec["model"], "model_args": rec["model_args"],
            "init": rec["init"], "actions": rec["actions"],
        }
        if rec.get("meta"):
            frame["meta"] = rec["meta"]
        return json.dumps(frame, sort_keys=True)
    events = []
    for etype, tid, tag, value in rec["events"]:
        if etype == "invoke":
            op = [tag] if value is None else [tag, value]
            events.append(["invoke", tid, op])
        else:
            events.append(["return", tid, _encode_ret(tag, value)])
    frame = {
        "v": WIRE_VERSION, "kind": "history", "id": rec["id"],
        "semantics": rec["semantics"],
        "spec": (
            {"type": "register", "default": rec["default"]}
            if rec["spec"] == "register" else {"type": "vec"}
        ),
        "events": events,
    }
    if rec.get("meta"):
        frame["meta"] = rec["meta"]
    return json.dumps(frame, sort_keys=True)


def _encode_ret(op_tag, value):
    if op_tag is None:
        return ["OrphanReturn"]
    want = _RET_TAG[op_tag]
    if want in ("WriteOk", "PushOk"):
        return [want]
    if want == "ReadOk":
        return ["ReadOk", value]
    if want == "PopOk":
        return ["PopOk", None if value == ("none",) else ["Some", value[1]]]
    return ["LenOk", value]


# -- shape bucketing --------------------------------------------------------


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def history_shape(rec: dict) -> Tuple[int, int]:
    """(threads C, max ops/thread O) of one decoded history — EXACT (not
    padded) for the history buckets: the packed predicates' verdicts are
    only host-bit-identical at the history's true (C, O), because
    phantom threads/slots change nothing but phantom *capacity* errors
    would. Threads are the dense sorted set of ids that ever appear."""
    counts: Dict[int, int] = {}
    for etype, tid, _tag, _value in rec["events"]:
        if etype == "invoke":
            counts[tid] = counts.get(tid, 0) + 1
        else:
            counts.setdefault(tid, counts.get(tid, 0))
    C = max(1, len(counts))
    O = max([1] + list(counts.values()))
    return C, O


def bucket_key(rec: dict) -> tuple:
    """The fixed-shape lane bucket one record batches into. Records in
    one bucket share every static shape, so a bucket is one batched
    dispatch (and one cached replay graph or audit program)."""
    if rec["kind"] == "trace":
        return (
            "trace",
            rec["model"],
            tuple(sorted((k, repr(v)) for k, v in rec["model_args"].items())),
            _next_pow2(len(rec["actions"])),
        )
    C, O = history_shape(rec)
    # The register audit program bakes ord(default) into its
    # predicate, so two histories with the same shape but different
    # defaults must NOT batch into one dispatch — the second would be
    # audited against the wrong initial register value. Vec histories
    # have no default; key None so they still share a bucket.
    default = rec["default"] if rec["spec"] == "register" else None
    return ("history", rec["spec"], rec["semantics"], C, O, default)


def bucket_records(records: Sequence[dict]) -> Dict[tuple, List[dict]]:
    """Stable-order bucketing: records keep upload order inside their
    bucket and buckets keep first-appearance order (verdict order must
    be a pure function of the upload, not of dict iteration)."""
    out: Dict[tuple, List[dict]] = {}
    for rec in records:
        out.setdefault(bucket_key(rec), []).append(rec)
    return out
