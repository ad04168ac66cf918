"""Judging the window's answers against the plain reference, once the
window has closed.

The answers the windows sampled from the seed are compared: each served
pool entry's first sampled answer, roots and sources word by word (and,
for documents, each word's row, byte span and document), with the
reference, and every later sampled answer of the entry with that one as
it completed (``drivers.Answers``); each sampled index build's postings
root key by root key. Every number compared is exact, so each has the
limit 0.
"""
from __future__ import annotations

import numpy as np

from stembench import arabic as ar
from stembench import reference

SAMPLE_DOCS = 32    # documents the host front end re-reads from their text


def judge(kind: str, driver, lost: int, dictionary, config,
          seed: int) -> dict:
    """``lost``: the windows' requests with no sound answer ->
    {name: (number, limit)} and the count of failed answers."""
    ref = reference.Stemmer(dictionary, infix=config["infix"])
    roots, sources = ref.stem_rows(driver.table.rows)
    numbers = {"empty_window": (int(not len(driver.answers)), 0)}
    if kind == "serve":
        got, failed = _serve(driver, lost, roots, sources, seed)
    else:
        got, failed = _index(driver, roots, sources)
    numbers.update(got)
    return numbers, failed


def _serve(driver, lost, tok_roots, tok_sources, seed):
    table, text = driver.table, driver.text
    if text:
        _check_geometry(driver, seed)
    answers = driver.answers
    # later answers that differ from their entry's kept one, or misshapen
    wrong_words = answers.changed + answers.misshapen
    wrong_geo = answers.changed_geometry + (answers.misshapen if text else 0)
    bad = answers.bad
    for k, got in answers:
        roots, sources = got["roots"], got["sources"]
        toks = driver.tokens[k]
        flat = toks.reshape(-1)
        w_roots, w_sources = tok_roots[flat], tok_sources[flat]
        if text:
            geo = reference.text_geometry(table, toks)
        wrong = (roots != w_roots).any(axis=1) | (sources != w_sources)
        if text:
            geo_wrong = ((got["words"] != geo[0]).any(axis=1)
                         | (got["spans"] != geo[1]).any(axis=1)
                         | (got["doc_ids"] != geo[2]))
            wrong_geo += int(geo_wrong.sum())
            wrong |= geo_wrong
        n_wrong = int(wrong.sum())
        wrong_words += n_wrong
        bad += n_wrong > 0
    numbers = {"wrong_words": (wrong_words, 0),
               "lost_requests": (lost, 0)}
    if text:
        numbers["wrong_text_geometry"] = (wrong_geo, 0)
    return numbers, bad + lost


def _check_geometry(driver, seed) -> None:
    """The host front end, run on a sample of the pool's documents drawn
    from the seed, must give the rows and spans the reference gathers from
    the token table; anything else is a fault of the benchmark itself."""
    rng = np.random.default_rng([seed, 3])
    n_req, n_docs = driver.tokens.shape[:2]
    for i in rng.choice(n_req * n_docs, size=min(SAMPLE_DOCS, n_req * n_docs),
                        replace=False):
        k, d = divmod(int(i), n_docs)
        rows, spans = ar.analyze_text(driver.pool[k][d])
        w_rows, w_spans, _ = reference.text_geometry(
            driver.table, driver.tokens[k][d:d + 1])
        if not (np.array_equal(rows, w_rows)
                and np.array_equal(spans, w_spans)):
            raise RuntimeError(f"the benchmark's document {k}/{d} does not"
                               " read back as its tokens")


def _index(driver, tok_roots, tok_sources):
    tok_keys = reference.root_keys(tok_roots, tok_sources)
    want: dict[int, reference.Index] = {}
    wrong = bad = 0
    for k, idx in driver.answers:
        if k not in want:
            chunks = driver.pool[k]
            want[k] = reference.Index.build(
                tok_keys[driver.tokens[k]],
                np.concatenate([c.doc_ids for c in chunks]),
                np.concatenate([c.positions for c in chunks]))
        n = reference.wrong_roots(reference.Index.of_program(idx), want[k])
        wrong += n
        bad += n > 0
    return {"wrong_roots": (wrong, 0)}, bad
