"""Text serving: documents in, per-token (root, source, byte span) out.

The counterpart of ``repro.serve.text``. :class:`TextAnalysisWorkload`
moves the serving boundary from pre-packed ``[block_b, 16]`` word tiles to
raw text without touching the machinery underneath: it subclasses
:class:`StemmerWorkload` and overrides only ``make_request``. Admission
coalesces a request's documents into one codepoint tile (a single 0
separator between documents, bucketed to a pow2 multiple of
``char_block``), runs the text front end to get normalised word rows and
utf-8 byte spans, attributes each word to its document by span offset,
and hands the word rows to the unchanged pipeline: the dispatch/retire
ring, megabatching, ``data_devices`` sharding over a mesh (and its
``mesh=``), persistent descriptor-ring launches and hot swaps serve text
requests exactly as they serve word-tile requests. Results
scatter back per document through :meth:`TextRequest.analyses`.

The front end runs at admission, on the store's device, not inside the
stemmer launch: word counts depend on the data, and the ring's fixed
``[launch_b, 16]`` staging needs them on the host (one sync a request).
The chained device path is ``ops.extract_roots_text``.

The fault path comes through the same inheritance: retries, bisection,
quarantine, deadlines and the watchdog serve text requests as word
requests, and :meth:`TextRequest.analyses` raises on a request that
failed. The journal stores a text submission as its raw documents, so
``Engine.recover`` replays the text through ``make_request``: the front
end is deterministic, so the recovered rows, spans and roots are
bit-identical.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import alphabet as ab
from repro_torch.core import textnorm as tn
from repro_torch.serve.engine import StemmerWorkload, StemRequest

FRONTENDS = ("kernel", "reference", "host")


@dataclass
class TextRequest(StemRequest):
    """A document-batch request; words/roots/sources/dict_versions hold
    the flattened per-token state in document order (StemRequest fields),
    plus the text-level view needed to scatter results back per doc."""

    docs: list = field(default_factory=list)   # original documents
    doc_ids: np.ndarray = None                 # int32 [n] doc index per word
    spans: np.ndarray = None                   # int32 [n, 2] per-doc byte span
    n_bytes: int = 0                           # utf-8 bytes across docs

    def analyses(self) -> list[list[tuple[str, int, tuple[int, int]]]]:
        """Per-document [(root, source, (byte_start, byte_end))].

        A terminally failed request (quarantined, deadline, shed,
        cancelled: ``self.failure`` is set) holds zero-filled roots for
        its unserved words, so it raises instead of returning them.
        """
        if self.failure is not None:
            raise RuntimeError(
                f"request {self.rid} failed ({self.failure.code}:"
                f" {self.failure.detail}); no analyses to read")
        out: list[list] = [[] for _ in self.docs]
        for i in range(self.n_words):
            out[int(self.doc_ids[i])].append(
                (ab.decode_word(self.roots[i]), int(self.sources[i]),
                 (int(self.spans[i, 0]), int(self.spans[i, 1]))))
        return out


class TextAnalysisWorkload(StemmerWorkload):
    """StemmerWorkload whose public payload is text.

    frontend="kernel"     the text front-end kernel K4 through
                          ``ops.text_to_words`` (its plain version on the
                          CPU; the default)
    frontend="reference"  the plain scatter-based
                          ``textnorm.frontend_reference``
    frontend="host"       Python ``textnorm.analyze_text_py`` per document

    All three are bit-identical; the host path is the oracle the others
    are checked against.
    """

    def __init__(self, store, *, char_block: int = 2048,
                 text_block_w: int = 128, frontend: str = "kernel", **kw):
        if frontend not in FRONTENDS:
            raise ValueError(f"unknown frontend {frontend!r}"
                             f" (choose from {FRONTENDS})")
        if char_block < 128:
            raise ValueError(f"char_block must be >= 128, got {char_block}")
        super().__init__(store, **kw)
        self.char_block = char_block
        self.text_block_w = text_block_w
        self.frontend = frontend

    # -- admission: text -> word rows --------------------------------------
    def _char_bucket(self, n: int) -> int:
        """Smallest char_block * 2^k >= n (pow2 buckets bound the tile
        shapes a ragged document stream produces)."""
        b = self.char_block
        while b < n:
            b *= 2
        return b

    def make_request(self, rid: int, docs, **opts) -> TextRequest:
        if opts:
            raise ValueError(f"unknown text request options: {sorted(opts)}")
        if isinstance(docs, str):
            docs = [docs]
        docs = list(docs)
        for d in docs:
            if not isinstance(d, str):
                raise ValueError(
                    "text workload takes str documents, got"
                    f" {type(d).__name__}")
        with tracing.span("text.coalesce", rid):
            chars, _char_off, byte_off = tn.coalesce_docs(docs)
            n_bytes = sum(len(d.encode("utf-8")) for d in docs)
        if self.frontend == "host":
            words, spans, doc_ids = self._frontend_host(docs)
        else:
            words, spans, doc_ids = self._frontend_device(chars, byte_off,
                                                          rid)
        n = words.shape[0]
        return TextRequest(
            rid, np.ascontiguousarray(words, np.int32),
            roots=np.zeros((n, 4), np.int32),
            sources=np.zeros(n, np.int32),
            dict_versions=np.zeros(n, np.int32),
            docs=docs, doc_ids=doc_ids, spans=spans, n_bytes=n_bytes)

    def _frontend_host(self, docs):
        parts = [tn.analyze_text_py(d) for d in docs]
        words = (np.concatenate([w for w, _ in parts])
                 if parts else np.zeros((0, ab.MAXLEN), np.int32))
        spans = (np.concatenate([s for _, s in parts])
                 if parts else np.zeros((0, 2), np.int32))
        doc_ids = (np.concatenate(
            [np.full(w.shape[0], i, np.int32)
             for i, (w, _) in enumerate(parts)])
            if parts else np.zeros(0, np.int32))
        return words, spans, doc_ids

    def _frontend_device(self, chars, byte_off, rid: int):
        from repro_torch.kernels import ops  # lazy: keep engine import light

        tile = np.zeros(self._char_bucket(max(chars.shape[0], 1)), np.int32)
        tile[:chars.shape[0]] = chars
        if self.frontend == "kernel":
            words_d, spans_d, nw = ops.text_to_words(
                tile, block_w=self.text_block_w, device=self.device)
        else:
            words_d, geo = tn.frontend_reference(
                torch.from_numpy(tile).to(self.device),
                block_w=self.text_block_w)
            spans_d, nw = geo.spans, geo.n_words
        with tracing.span("text.readback", rid):   # the host waits here
            n = int(nw)
            words = words_d[:n].cpu().numpy()
            spans_abs = spans_d[:n].cpu().numpy().astype(np.int64)
        with tracing.span("text.doc_ids", rid):
            if byte_off.size:
                # word -> owning doc: the last doc whose byte offset is <=
                # the word's absolute byte start (separators add one byte)
                doc_ids = (np.searchsorted(byte_off, spans_abs[:, 0],
                                           side="right") - 1).astype(np.int32)
                spans = (spans_abs
                         - byte_off[doc_ids][:, None]).astype(np.int32)
            else:
                doc_ids = np.zeros(0, np.int32)
                spans = spans_abs.astype(np.int32)
        return words, spans, doc_ids
