"""Tag trees for packet-header inclusion / zero-bitplane coding.

Parity: TagTree (SURVEY.md §2.1 "Tier-2", src/lib/core/t2/ [P]; algorithm
per ISO/IEC 15444-1 B.10.2): a quad-tree over the precinct's codeblock grid
where each node's value is the minimum of its children.  Coding is
incremental and resumable across layers: each node remembers the lower bound
(`low`) already communicated and whether its exact value is known to the
decoder.
"""

from __future__ import annotations

from .bitio import BitReader, BitWriter

_UNKNOWN = 999999999


class _Node:
    __slots__ = ("parent", "value", "low", "known")

    def __init__(self, parent: "_Node | None") -> None:
        self.parent = parent
        self.value = _UNKNOWN
        self.low = 0
        self.known = False


class TagTree:
    def __init__(self, w: int, h: int) -> None:
        self.w = max(w, 1) if w else 0
        self.h = max(h, 1) if h else 0
        self.leaves: list[_Node] = []
        if w <= 0 or h <= 0:
            return
        # build levels bottom-up
        levels: list[list[_Node]] = []
        lw, lh = w, h
        dims = []
        while True:
            dims.append((lw, lh))
            if lw == 1 and lh == 1:
                break
            lw = (lw + 1) // 2
            lh = (lh + 1) // 2
        # create from root (last dim) downward
        prev: list[_Node] | None = None
        for (lw, lh) in reversed(dims):
            cur: list[_Node] = []
            for j in range(lh):
                for i in range(lw):
                    if prev is None:
                        parent = None
                    else:
                        pw = (lw + 1) // 2
                        parent = prev[(j // 2) * pw + (i // 2)]
                    cur.append(_Node(parent))
            prev = cur
            levels.append(cur)
        self.leaves = levels[-1]

    def reset(self) -> None:
        node_sets = set()
        stack = list(self.leaves)
        while stack:
            n = stack.pop()
            if id(n) in node_sets:
                continue
            node_sets.add(id(n))
            n.value = _UNKNOWN
            n.low = 0
            n.known = False
            if n.parent is not None:
                stack.append(n.parent)

    # ------------------------------------------------------------ encoder

    def set_value(self, leafno: int, value: int) -> None:
        node: _Node | None = self.leaves[leafno]
        while node is not None and node.value > value:
            node.value = value
            node = node.parent

    def encode(self, bio: BitWriter, leafno: int, threshold: int) -> None:
        stack: list[_Node] = []
        node = self.leaves[leafno]
        while node.parent is not None:
            stack.append(node)
            node = node.parent
        low = 0
        while True:
            if low > node.low:
                node.low = low
            else:
                low = node.low
            while low < threshold:
                if low >= node.value:
                    if not node.known:
                        bio.write_bit(1)
                        node.known = True
                    break
                bio.write_bit(0)
                low += 1
            node.low = low
            if not stack:
                break
            node = stack.pop()

    # ------------------------------------------------------------ decoder

    def decode(self, bio: BitReader, leafno: int, threshold: int) -> bool:
        """Advance knowledge of leaf `leafno` up to `threshold`.

        Returns True iff the leaf's value is known and < threshold
        (e.g. "codeblock included in a layer < threshold")."""
        stack: list[_Node] = []
        node = self.leaves[leafno]
        while node.parent is not None:
            stack.append(node)
            node = node.parent
        low = 0
        while True:
            if low > node.low:
                node.low = low
            else:
                low = node.low
            while low < threshold and low < node.value:
                if bio.read_bit():
                    node.value = low
                else:
                    low += 1
            node.low = low
            if not stack:
                break
            node = stack.pop()
        return node.value < threshold

    def leaf_value(self, leafno: int) -> int:
        return self.leaves[leafno].value
