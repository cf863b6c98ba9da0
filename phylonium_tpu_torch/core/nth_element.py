"""libstdc++-compatible ``std::nth_element``.

The reference picks its first-pass reference genome with
``std::nth_element`` by sequence length (`src/phylonium.cxx:366-371`).
With distinct lengths any selection algorithm agrees, but with *tied*
lengths the element that lands at position ``n/2`` depends on the exact
introselect implementation.  For bit-parity with reference binaries built
against libstdc++, this module reimplements its introselect
(bits/stl_algo.h: __introselect, __unguarded_partition_pivot,
__move_median_to_first, __insertion_sort, __heap_select) over a Python
list with a strict-weak-order comparator.

The algorithm is the classic Musser introselect — public-domain knowledge;
this is a re-derivation for tie-compatibility, not copied code.

A copy of the JAX package's ``phylonium_tpu/core/nth_element.py``: the port carries
its own host layer and imports nothing of that package.
"""

from __future__ import annotations


def _move_median_to_first(a, comp, result, i1, i2, i3):
    if comp(a[i1], a[i2]):
        if comp(a[i2], a[i3]):
            a[result], a[i2] = a[i2], a[result]
        elif comp(a[i1], a[i3]):
            a[result], a[i3] = a[i3], a[result]
        else:
            a[result], a[i1] = a[i1], a[result]
    elif comp(a[i1], a[i3]):
        a[result], a[i1] = a[i1], a[result]
    elif comp(a[i2], a[i3]):
        a[result], a[i3] = a[i3], a[result]
    else:
        a[result], a[i2] = a[i2], a[result]


def _unguarded_partition(a, comp, first, last, pivot):
    while True:
        while comp(a[first], a[pivot]):
            first += 1
        last -= 1
        while comp(a[pivot], a[last]):
            last -= 1
        if not (first < last):
            return first
        a[first], a[last] = a[last], a[first]
        first += 1


def _unguarded_partition_pivot(a, comp, first, last):
    mid = first + (last - first) // 2
    _move_median_to_first(a, comp, first, first + 1, mid, last - 1)
    return _unguarded_partition(a, comp, first + 1, last, first)


def _insertion_sort(a, comp, first, last):
    if first == last:
        return
    for i in range(first + 1, last):
        if comp(a[i], a[first]):
            value = a[i]
            a[first + 1 : i + 1] = a[first:i]
            a[first] = value
        else:
            value = a[i]
            nxt = i - 1
            hole = i
            while comp(value, a[nxt]):
                a[hole] = a[nxt]
                hole = nxt
                nxt -= 1
            a[hole] = value


def _push_heap(a, comp, first, hole, top, value):
    parent = (hole - 1) // 2
    while hole > top and comp(a[first + parent], value):
        a[first + hole] = a[first + parent]
        hole = parent
        parent = (hole - 1) // 2
    a[first + hole] = value


def _adjust_heap(a, comp, first, hole, length, value):
    top = hole
    second = hole
    while second < (length - 1) // 2:
        second = 2 * (second + 1)
        if comp(a[first + second], a[first + second - 1]):
            second -= 1
        a[first + hole] = a[first + second]
        hole = second
    if (length & 1) == 0 and second == (length - 2) // 2:
        second = 2 * (second + 1)
        a[first + hole] = a[first + second - 1]
        hole = second - 1
    _push_heap(a, comp, first, hole, top, value)


def _make_heap(a, comp, first, last):
    length = last - first
    if length < 2:
        return
    parent = (length - 2) // 2
    while True:
        value = a[first + parent]
        _adjust_heap(a, comp, first, parent, length, value)
        if parent == 0:
            return
        parent -= 1


def _pop_heap(a, comp, first, last, result):
    value = a[result]
    a[result] = a[first]
    _adjust_heap(a, comp, first, 0, last - first, value)


def _heap_select(a, comp, first, middle, last):
    _make_heap(a, comp, first, middle)
    for i in range(middle, last):
        if comp(a[i], a[first]):
            _pop_heap(a, comp, first, middle, i)


def nth_element(a: list, nth: int, comp=None) -> None:
    """In-place nth_element with libstdc++ semantics."""
    if comp is None:
        comp = lambda x, y: x < y  # noqa: E731

    first, last = 0, len(a)
    if first == last or nth == last:
        return

    n = last - first
    depth_limit = 2 * (n.bit_length() - 1) if n > 0 else 0

    while last - first > 3:
        if depth_limit == 0:
            _heap_select(a, comp, first, nth + 1, last)
            a[first], a[nth] = a[nth], a[first]
            return
        depth_limit -= 1
        cut = _unguarded_partition_pivot(a, comp, first, last)
        if cut <= nth:
            first = cut
        else:
            last = cut

    _insertion_sort(a, comp, first, last)
