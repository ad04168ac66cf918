"""Write-ahead request journal: the engine's crash-safety spine.

The counterpart of ``repro.serve.journal``: the same record format,
codec and hashes, so a journal written by either package's engine is
recovered by the other's.

Everything the engine accepts is durable before it is served, and
everything it serves is marked durable after — so a killed process
loses no accepted work, and a restarted one re-serves exactly the
unfinished suffix.

Record format — one record per line, sha-disciplined like the index
checkpoints (content hash verified before anything is trusted):

    <sha16> <canonical-json>\\n

where ``sha16 = sha256(json_utf8)[:16]``. Two record kinds:

  admit   {"kind": "admit", "rid", "payload": <codec>, "digest",
           "deadline_s", "dict_version", "opts"}
          appended by ``Engine.submit`` *before* the request enters the
          queue. ``payload`` is the submitted payload itself (encoded
          word tiles, raw strings, or document lists — replay needs the
          bytes, not just a fingerprint); ``digest`` is its content
          hash, re-verified at replay; ``dict_version`` is the store
          version current at admission, which recovery re-pins so the
          request is served under the exact lexicon it was accepted for.
  retire  {"kind": "retire", "rid", "digest", "failure"}
          appended when the request reaches the finished table —
          ``digest`` hashes the response arrays (None for terminal
          failures, whose ``failure`` carries the FailureInfo code).

Durability: every append is written + flushed to the OS (surviving
process death); ``fsync_every`` batches the fsync that also survives
host power loss. A *torn tail* — the trailing record failing its
checksum or framing, what a crash mid-write leaves — is truncated by
:meth:`Journal.read`; records are trusted only up to the first bad one
(standard WAL semantics: ordering after a tear is unprovable).

Replay is bit-identical by construction: the megakernel's per-word
output is independent of tile packing (parity-tested across every
launch path), so re-running the unfinished admits through the normal
FIFO-coalescing path reproduces the uninterrupted run's bytes even
though the restarted engine coalesces different tile boundaries.
Partially served requests are re-served from word 0 — re-doing a
deterministic launch is cheaper than journaling per-tile scatter state.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class RecoveryReport:
    """What Engine.recover found in the journal: the rids it re-queued,
    how many were already retired (skipped), and the torn-tail bytes it
    truncated."""

    replayed: list = field(default_factory=list)
    already_retired: int = 0
    dropped_bytes: int = 0


class JournalError(RuntimeError):
    """A journal record that parsed but cannot be trusted (payload
    digest mismatch, undecodable payload codec)."""


def _sha16(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


# ---------------------------------------------------------------------------
# payload codec: what Engine.submit accepts must round-trip through JSON
# ---------------------------------------------------------------------------
def encode_payload(payload) -> dict:
    """Submitted payload -> JSON-safe codec dict (ndarray via base64,
    strings and homogeneous str/int lists verbatim)."""
    if isinstance(payload, np.ndarray):
        a = np.ascontiguousarray(payload)
        return {"t": "nd", "dtype": str(a.dtype), "shape": list(a.shape),
                "b64": base64.b64encode(a.tobytes()).decode("ascii")}
    if isinstance(payload, str):
        return {"t": "str", "s": payload}
    if isinstance(payload, (list, tuple)):
        items = list(payload)
        if all(isinstance(x, str) for x in items):
            return {"t": "strs", "items": items}
        if all(isinstance(x, (int, np.integer)) for x in items):
            return {"t": "ints", "items": [int(x) for x in items]}
    raise TypeError(
        f"journal cannot encode payload of type {type(payload).__name__}"
        " (want ndarray, str, or a homogeneous list of str/int)")


def decode_payload(enc: dict):
    t = enc.get("t")
    if t == "nd":
        a = np.frombuffer(base64.b64decode(enc["b64"]),
                          dtype=np.dtype(enc["dtype"]))
        return a.reshape(enc["shape"]).copy()
    if t == "str":
        return enc["s"]
    if t == "strs":
        return list(enc["items"])
    if t == "ints":
        return [int(x) for x in enc["items"]]
    raise JournalError(f"unknown payload codec {t!r}")


def payload_digest(payload) -> str:
    """Content hash of a payload, stable across encode/decode."""
    enc = encode_payload(payload)
    return _sha16(json.dumps(enc, sort_keys=True,
                             separators=(",", ":")).encode())


def response_digest(req) -> str | None:
    """Content hash of a finished request's response: (roots, sources)
    for stemmer/text requests, the token list for LM requests — the
    integrity anchor crash-restart tests compare against."""
    roots = getattr(req, "roots", None)
    if roots is not None:
        return _sha16(np.ascontiguousarray(roots).tobytes()
                      + np.ascontiguousarray(req.sources).tobytes())
    toks = getattr(req, "tokens_out", None)
    if toks is not None:
        return _sha16(json.dumps([int(t) for t in toks]).encode())
    return None


# ---------------------------------------------------------------------------
# the journal
# ---------------------------------------------------------------------------
class Journal:
    """Append-only, checksummed, batch-fsynced request log."""

    def __init__(self, path, *, fsync_every: int = 32, injector=None):
        if fsync_every < 1:
            raise ValueError(f"fsync_every must be >= 1, got {fsync_every}")
        self.path = str(path)
        self.fsync_every = fsync_every
        self.injector = injector
        self.appended = 0
        self._since_sync = 0
        self._f = open(self.path, "ab")

    # -- writer side -------------------------------------------------------
    def _append(self, rec: dict) -> None:
        body = json.dumps(rec, sort_keys=True, separators=(",", ":"))
        line = f"{_sha16(body.encode())} {body}\n".encode()
        self._f.write(line)
        self._f.flush()                 # survives process death
        self.appended += 1
        self._since_sync += 1
        if self._since_sync >= self.fsync_every:
            os.fsync(self._f.fileno())  # survives power loss, batched
            self._since_sync = 0
        if self.injector is not None:
            self.injector.on_journal(self.path, len(line))

    def admit(self, rid: int, payload, *, deadline_s: float | None = None,
              dict_version: int | None = None, opts: dict | None = None):
        enc = encode_payload(payload)
        self._append({
            "kind": "admit", "rid": int(rid), "payload": enc,
            "digest": _sha16(json.dumps(enc, sort_keys=True,
                                        separators=(",", ":")).encode()),
            "deadline_s": deadline_s,
            "dict_version": (None if dict_version is None
                             else int(dict_version)),
            "opts": dict(opts or {})})

    def retire(self, req) -> None:
        failure = getattr(req, "failure", None)
        self._append({
            "kind": "retire", "rid": int(req.rid),
            "digest": response_digest(req) if failure is None else None,
            "failure": None if failure is None else failure.code})

    def sync(self) -> None:
        self._f.flush()
        os.fsync(self._f.fileno())
        self._since_sync = 0

    def close(self) -> None:
        if not self._f.closed:
            self.sync()
            self._f.close()

    # -- reader side -------------------------------------------------------
    @staticmethod
    def read(path, *, truncate: bool = True) -> tuple[list[dict], int]:
        """Parse a journal, stopping at the first torn/corrupt record;
        returns (records, dropped_bytes). With ``truncate`` (default)
        the file is physically cut back to the last good record so a
        recovered engine appends onto a clean tail."""
        path = str(path)
        if not os.path.exists(path):
            return [], 0
        with open(path, "rb") as f:
            data = f.read()
        records, off, good = [], 0, 0
        while off < len(data):
            nl = data.find(b"\n", off)
            if nl < 0:
                break                   # unterminated (torn) tail
            line = data[off:nl]
            try:
                sha, body = line.split(b" ", 1)
                if sha.decode("ascii") != _sha16(body):
                    break
                rec = json.loads(body.decode("utf-8"))
            except Exception:
                break
            records.append(rec)
            off = good = nl + 1
        dropped = len(data) - good
        if dropped and truncate:
            with open(path, "r+b") as f:
                f.truncate(good)
        return records, dropped


def unfinished_admits(records: list[dict]) -> list[dict]:
    """Admit records with no matching retire, in journal (= rid) order —
    exactly the work a recovered engine owes."""
    retired = {int(r["rid"]) for r in records if r.get("kind") == "retire"}
    return [r for r in records
            if r.get("kind") == "admit" and int(r["rid"]) not in retired]
