"""Condition tree for conditional search spaces.

Capability parity with the reference's `Node` tree
(ref: bayes_optim/search_space/node.py:7-193): a forest of variable-dependency
trees whose edges carry activation conditions (Python-expression strings). Used
by `SearchSpace.get_unconditional_subspace` to enumerate the flat subspaces a
conditional space decomposes into, and by `ConditionalBO` to route sub-
optimizers. Re-implemented from the dict spec semantics.
"""
from __future__ import annotations

from copy import copy, deepcopy
from typing import Any, Dict, List, Optional, Tuple


class Node:
    """A node in a condition tree; edges to children carry branch conditions."""

    def __init__(self, name: str, data: Any = None):
        self.name = name
        self.data = data
        self.is_root: bool = True
        self.children: List["Node"] = []
        self.branches: List[Optional[str]] = []

    def add_child(self, node: "Node", branch: Optional[str] = None) -> "Node":
        node.is_root = False
        self.children.append(node)
        self.branches.append(branch)
        return self

    # -- (de)serialization -------------------------------------------------
    @classmethod
    def from_dict(cls, d: Dict[str, List[dict]]) -> List["Node"]:
        """Build a forest from `{parent: [{"name": child, "condition": expr}, ...]}`.

        Returns the list of root nodes (parents that are nobody's child).
        """
        nodes: Dict[str, Node] = {}

        def get(name: str) -> Node:
            if name not in nodes:
                nodes[name] = cls(name)
            return nodes[name]

        for parent, entries in d.items():
            p = get(parent)
            for e in entries:
                p.add_child(get(e["name"]), e.get("condition"))
        return [n for n in nodes.values() if n.is_root]

    def to_dict(self) -> Dict[str, List[dict]]:
        out: Dict[str, List[dict]] = {}
        stack = [self]
        while stack:
            node = stack.pop()
            for child, branch in zip(node.children, node.branches):
                out.setdefault(node.name, []).append({"name": child.name, "condition": branch})
                stack.append(child)
        return out

    # -- structural ops ----------------------------------------------------
    def deepcopy(self) -> "Node":
        return self.remove([])

    def remove(self, node_names: List[str], invert: bool = False) -> Optional["Node"]:
        """Return a copy of the tree with the named nodes (and their subtrees)
        dropped; `invert=True` keeps only the named nodes."""
        dropped = (lambda n: n not in node_names) if invert else (lambda n: n in node_names)
        if dropped(self.name):
            return None
        clone = Node(self.name, deepcopy(self.data))
        for child, branch in zip(self.children, self.branches):
            kept = child.remove(node_names, invert)
            if kept is not None:
                clone.add_child(kept, copy(branch))
        return clone

    def get_all_name(self) -> List[str]:
        """Pre-order list of all node names in the tree."""
        out, stack = [], [self]
        while stack:
            n = stack.pop(0)
            out.append(n.name)
            stack = n.children + stack
        return out

    def get_all_path(self) -> Dict[Tuple[str, ...], Optional[List[str]]]:
        """Map each root-to-leaf branch-condition path to the variable names it
        activates (ref parity: node.py:169-186 — intermediate selector names
        are excluded, direct children of a branch are included)."""
        if not self.children:
            return {(): None}
        merged: Dict[Tuple[str, ...], List[str]] = {}
        for child, branch in zip(self.children, self.branches):
            for sub_path, sub_vars in child.get_all_path().items():
                if sub_vars is None:  # child itself is a leaf
                    merged.setdefault((branch,), []).append(child.name)
                else:
                    merged.setdefault((branch,) + sub_path, []).extend(sub_vars)
        return merged

    def pprint(self, _prefix: str = "", branch: Optional[str] = None, _last: bool = True) -> None:
        tag = "`- " if _last else "|- "
        if branch:
            tag += f"<{branch}> - "
        print(f"{_prefix}{tag}{self.name}")
        child_prefix = _prefix + ("" if _last else "|") + " " * len(tag)
        for i, (child, br) in enumerate(zip(self.children, self.branches)):
            child.pprint(child_prefix, br, i == len(self.children) - 1)

    def __str__(self) -> str:
        return self.name

    def __repr__(self) -> str:
        return self.name
