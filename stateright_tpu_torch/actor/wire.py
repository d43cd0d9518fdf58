"""JSON wire codecs for the register message protocol (used by ``spawn``).

Format matches the reference examples' serde-JSON representation, e.g.
``{"Put": [1, "X"]}``, ``{"Get": [2]}``, ``{"PutOk": [1]}``,
``{"GetOk": [2, "X"]}``, ``{"Internal": ...}``.
"""

from __future__ import annotations

import json

from .register import Get, GetOk, Internal, Put, PutOk


def register_msg_to_wire(msg) -> bytes:
    if isinstance(msg, Put):
        doc = {"Put": [msg.request_id, _value_to_doc(msg.value)]}
    elif isinstance(msg, Get):
        doc = {"Get": [msg.request_id]}
    elif isinstance(msg, PutOk):
        doc = {"PutOk": [msg.request_id]}
    elif isinstance(msg, GetOk):
        doc = {"GetOk": [msg.request_id, _value_to_doc(msg.value)]}
    elif isinstance(msg, Internal):
        doc = {"Internal": _value_to_doc(msg.msg)}
    else:
        doc = _value_to_doc(msg)
    return json.dumps(doc).encode()


def register_msg_from_wire(data: bytes):
    doc = json.loads(data.decode())
    if isinstance(doc, dict):
        if "Put" in doc:
            return Put(doc["Put"][0], _doc_to_value(doc["Put"][1]))
        if "Get" in doc:
            return Get(doc["Get"][0])
        if "PutOk" in doc:
            return PutOk(doc["PutOk"][0])
        if "GetOk" in doc:
            return GetOk(doc["GetOk"][0], _doc_to_value(doc["GetOk"][1]))
        if "Internal" in doc:
            return Internal(_doc_to_value(doc["Internal"]))
    return _doc_to_value(doc)


def _value_to_doc(value):
    """Tuples become lists (JSON has no tuple type)."""
    if isinstance(value, tuple):
        return [_value_to_doc(v) for v in value]
    if isinstance(value, list):
        return [_value_to_doc(v) for v in value]
    if isinstance(value, dict):
        return {k: _value_to_doc(v) for k, v in value.items()}
    return value


def _doc_to_value(doc):
    """Lists become tuples so deserialized messages hash/compare like the
    originals."""
    if isinstance(doc, list):
        return tuple(_doc_to_value(v) for v in doc)
    if isinstance(doc, dict):
        return {k: _doc_to_value(v) for k, v in doc.items()}
    return doc
