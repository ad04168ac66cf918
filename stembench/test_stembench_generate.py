"""The benchmark's frozen copies of the generators and the host front end
reproduce the program's own (``repro_torch.core``) at a small size."""
import numpy as np
import pytest
import torch

from repro_torch.core import alphabet as pab
from repro_torch.core import corpus as pcorpus
from repro_torch.core import stemmer as pstemmer
from repro_torch.core import textnorm as ptn
from repro_torch.launch.serve import edge_documents
from stembench import arabic as ar
from stembench import generate

TOKENS = {"forms_per_root": 24, "clitic_every": 3, "zipf_a": 1.3}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def table():
    return generate.build_token_table(TOKENS)


def test_token_table_is_the_programs(table):
    want = pcorpus.build_token_table()
    assert table.texts == want.texts
    assert np.array_equal(table.rows, want.rows)
    assert np.array_equal(table.probs, want.probs)
    assert table.n_tokens == 5767
    assert np.array_equal(table.n_bytes,
                          [len(t.encode("utf-8")) for t in want.texts])


@pytest.mark.parametrize("seed", [0, 2**33 + 7])
def test_drawn_words_are_the_corpus_streams(table, seed):
    chunks = list(pcorpus.stream_corpus_words(3000, seed=seed,
                                              chunk_words=1024))
    for c, ch in enumerate(chunks):
        toks = generate.draw_tokens(table, ch.n_words, [seed, c])
        assert np.array_equal(table.rows[toks], ch.words)


@pytest.mark.parametrize("seed", [0, 5])
def test_dictionaries_are_the_programs(seed):
    d = generate.build_dictionary({"n_tri": 400, "n_quad": 60}, seed)
    want = pstemmer.RootDictArrays.from_rootdict(
        pcorpus.build_dictionary(n_tri=400, n_quad=60, seed=seed),
        device="cpu")
    for got, w in zip((d.tri, d.quad, d.bi), want.numpy()):
        assert np.array_equal(got, w)
    grown = generate.build_dictionary(
        {"n_tri": 400, "n_quad": 60, "grow_to": 9000}, seed)
    want = pcorpus.grow_root_arrays(want, 9000, seed=seed)
    for got, w in zip((grown.tri, grown.quad, grown.bi), want.numpy()):
        assert np.array_equal(got, w)
    assert grown.n_keys == grown.n_roots == 9000


def test_host_front_end_is_the_programs(table):
    docs = edge_documents() + [generate.document(table, np.arange(0, 400))]
    for doc in docs:
        rows, spans = ar.analyze_text(doc)
        want_rows, want_spans = ptn.analyze_text_py(doc)
        assert np.array_equal(rows, want_rows)
        assert np.array_equal(spans, want_spans)
    for t in table.texts[:300] + ("أإآٱ", "كَتَبَ", ""):
        assert np.array_equal(ar.encode_word(t), pab.encode_word(t))
