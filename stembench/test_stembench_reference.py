"""The benchmark's frozen reference agrees with the port's CPU path on a
few thousand words and one small index, and its judgement of a window
counts what differs."""
import numpy as np
import pytest
import torch

from repro_torch.core import pyref
from repro_torch.core import stemmer as pstemmer
from repro_torch.index import build_corpus_index
from repro_torch.kernels import ops
from stembench import drivers, generate, reference

TOKENS = {"forms_per_root": 24, "clitic_every": 3, "zipf_a": 1.3}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setting():
    table = generate.build_token_table(TOKENS)
    d = generate.build_dictionary(
        {"n_tri": 2000, "n_quad": 200, "grow_to": 20_000}, 3)
    return table, d, pstemmer.RootDictArrays.from_numpy(d.tri, d.quad, d.bi,
                                                        device="cpu")


@pytest.mark.parametrize("infix", [True, False])
def test_stemmer_is_the_ports(setting, infix):
    table, d, arrays = setting
    rows = table.rows[generate.draw_tokens(table, 4096, [1, 2])]
    rows = np.concatenate([rows, table.rows])
    roots, sources = reference.Stemmer(d, infix=infix).stem_rows(rows)
    want_r, want_s = ops.extract_roots_fused(rows, arrays, infix=infix,
                                             device="cpu")
    assert np.array_equal(roots, want_r.numpy())
    assert np.array_equal(sources, want_s.numpy())
    if infix:
        assert (sources == pyref.SRC_RESTORED).any()
        assert (sources == pyref.SRC_DEINFIX_TRI).any()


def test_index_is_the_ports_by_root_key(setting):
    table, d, arrays = setting
    toks = generate.draw_tokens(table, 8192, [1, 3])
    gwi = np.arange(8192)
    chunks = [drivers.Chunk(table.rows[toks[a:a + 4096]],
                            gwi[a:a + 4096] // 100,
                            (gwi[a:a + 4096] % 100).astype(np.int32), a)
              for a in (0, 4096)]
    idx = build_corpus_index(iter(chunks), arrays, block_b=256, block_w=256,
                             device="cpu")
    keys = reference.root_keys(*reference.Stemmer(d).stem_rows(table.rows))
    want = reference.Index.build(keys[toks], gwi // 100, gwi % 100)
    got = reference.Index.of_program(idx)
    assert reference.wrong_roots(got, want) == 0
    assert want.keys.size > 100
    # one posting moved, one root dropped
    docs = got.docs.copy()
    docs[got.starts[5]] += 1
    moved = reference.Index(got.keys, got.counts, got.starts, docs,
                            got.positions)
    assert reference.wrong_roots(moved, want) == 1
    dropped = reference.Index(got.keys[1:], got.counts[1:], got.starts[1:],
                              got.docs, got.positions)
    assert reference.wrong_roots(dropped, want) == 1


def test_text_geometry_reads_back(setting):
    from stembench import arabic as ar

    table = setting[0]
    toks = generate.draw_tokens(table, 3 * 50, [4, 4]).reshape(3, 50)
    rows, spans, docs = reference.text_geometry(table, toks)
    for i in range(3):
        r, s = ar.analyze_text(generate.document(table, toks[i]))
        assert np.array_equal(r, rows[docs == i])
        assert np.array_equal(s, spans[docs == i])
