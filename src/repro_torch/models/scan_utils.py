"""Scans: a loop over a stack that stacks its outputs, and a parallel
prefix scan under an associative combine.

The counterpart of ``repro.models.scan_utils``, plus the counterpart of
``jax.lax.associative_scan`` that the reference's Mamba calls. Trees are
the port's (nested dicts, tuples and NamedTuples, ``params.tree_map``).
"""
from __future__ import annotations

import torch

from repro_torch.models import params as pm


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for part in tree for x in _leaves(part)]
    return [tree]


def scan(f, init, xs, *, unroll: bool = False):
    """f(carry, x) -> (carry, y) over the leading axis of every leaf of
    xs -> (the last carry, the ys stacked on a leading axis), as
    ``jax.lax.scan``. A Python loop: eager PyTorch has no compiled loop to
    unroll, so ``unroll`` changes nothing. An empty stack gives the
    initial carry and ys with a leading 0 of the shapes f gives one
    element."""
    del unroll
    n = int(_leaves(xs)[0].shape[0])
    if n == 0:
        _, y = f(init, pm.tree_map(lambda a: a.new_zeros(a.shape[1:]), xs))
        return init, pm.tree_map(lambda a: a.new_zeros((0, *a.shape)), y)
    # each leaf cut once by unbind (one stack in the backward pass, where
    # n indexings would each fill a zero gradient of the whole leaf)
    parts = [leaf.unbind(0) for leaf in _leaves(xs)]
    carry, ys = init, []
    for i in range(n):
        it = iter([p[i] for p in parts])
        carry, y = f(carry, pm.tree_map(lambda _: next(it), xs))
        ys.append(y)
    if not _leaves(ys[0]):
        return carry, ys[0]
    return carry, pm.tree_map(lambda *a: torch.stack(a), *ys)


def _pairs(x: torch.Tensor, dim: int):
    """x (of even length along dim) -> (x[0::2], x[1::2]) as views."""
    return x.unflatten(dim, (x.shape[dim] // 2, 2)).unbind(dim + 1)


def associative_scan(combine, elems, dim: int = 0):
    """The inclusive prefix scan of ``elems`` (a tuple of tensors of one
    length along ``dim``) under ``combine(left, right)``, an associative
    function of two such tuples: element i is elems[0] o ... o elems[i].

    ``jax.lax.associative_scan``'s odd/even recursion, so that each
    element associates as the reference's does: combine adjacent pairs,
    scan the pairs (the odd positions), then combine each odd result with
    the next element (the even positions). log2(T) levels of a few
    elementwise ops each, over all T at once; each level does half the
    work of the one before. Tensors are cut by ``unbind`` and ``split``,
    whose gradients are one stack or cat, never by slicing (a slice's
    gradient is a zero fill of its whole input and a scatter)."""
    elems = tuple(elems)
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    m = n // 2
    if n % 2:   # the last element waits for the even positions
        elems, last = zip(*(e.split([n - 1, 1], dim) for e in elems))
    split = [_pairs(e, dim) for e in elems]
    # positions 0, 2, ..., 2m-2: the first one, and the m - 1 after it
    first, rest = zip(*(s[0].split([1, m - 1], dim) for s in split))
    odd = associative_scan(combine, combine(      # positions 1, 3, ..., 2m-1
        tuple(s[0] for s in split), tuple(s[1] for s in split)), dim)
    # positions 2, 4, ...: the odd result before, combined with the element
    if n % 2:
        even = combine(odd, tuple(torch.cat([r, x], dim=dim)
                                  for r, x in zip(rest, last)))
        return tuple(
            torch.cat([f, torch.stack([o, v], dim=dim + 1).flatten(
                dim, dim + 1)], dim=dim)
            for f, o, v in zip(first, odd, even))
    head, tail = zip(*(o.split([m - 1, 1], dim) for o in odd))
    even = combine(head, rest)
    return tuple(
        torch.cat([f, torch.stack([o, v], dim=dim + 1).flatten(dim, dim + 1),
                   t], dim=dim)
        for f, o, v, t in zip(first, head, even, tail))
