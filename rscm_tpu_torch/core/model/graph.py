"""
Component dependency graph with reference-equivalent traversal order.

The reference stores components in a petgraph ``Graph`` and executes a BFS
from a ``NullComponent`` root each step (``model/runtime.rs:504-510``).
petgraph's ``neighbors`` iterates outgoing edges in *reverse insertion
order*; execution order parity therefore requires replicating both the BFS
queue discipline and that neighbor order — :meth:`ComponentGraph.bfs_order`
does exactly that.

Like the reference's Rust core, the traversal engine itself is native:
``native/graph_engine.cpp`` (bound via :mod:`rscm_tpu_torch.native`)
implements the same BFS / Kahn / cycle-detection contracts and is used when
its shared library builds and loads; the pure-Python implementations below
remain the fallback and the oracle the tests hold it against
(``RSCM_TPU_NATIVE=0`` forces them).  Both give the same order.
"""

from __future__ import annotations

from collections import deque
from typing import Any, List, Tuple

from ..errors import CircularDependencyError

__all__ = ["ComponentGraph", "NullComponent"]


class NullComponent:
    """Root node of the execution graph; solves nothing.

    Mirror of ``model/null_component.rs``.
    """

    def definitions(self):
        return []

    def inputs(self):
        return []

    def input_names(self):
        return []

    def outputs(self):
        return []

    def output_names(self):
        return []

    @property
    def component_name(self):
        return "NullComponent"

    def param_pytree(self):
        return {}

    def with_params(self, pytree):
        return self

    def create_initial_state(self):
        return None

    def solve_ctx(self, ctx, inputs, internal_state):
        return {}, internal_state

    def __repr__(self):
        return "NullComponent"


class ComponentGraph:
    """Directed multigraph of components; edges carry requirement metadata."""

    def __init__(self):
        self.nodes: List[Any] = []
        # edges in insertion order: (src, dst, payload)
        self.edges: List[Tuple[int, int, Any]] = []
        self._out: List[List[int]] = []  # node -> edge indices in insertion order

    def add_node(self, component) -> int:
        self.nodes.append(component)
        self._out.append([])
        return len(self.nodes) - 1

    def add_edge(self, src: int, dst: int, payload) -> int:
        idx = len(self.edges)
        self.edges.append((src, dst, payload))
        self._out[src].append(idx)
        return idx

    def neighbors(self, node: int):
        """Successors in petgraph order (reverse edge-insertion)."""
        return [self.edges[e][1] for e in reversed(self._out[node])]

    def _edge_pairs(self):
        return [(src, dst) for src, dst, _ in self.edges]

    @staticmethod
    def _native_engine():
        from ...native import load_graph_engine

        return load_graph_engine()

    def bfs_order(self, start: int) -> List[int]:
        """Breadth-first visit order from ``start`` (petgraph ``Bfs`` replica)."""
        engine = self._native_engine()
        if engine is not None:
            return engine.bfs_order(len(self.nodes), self._edge_pairs(), start)
        discovered = [False] * len(self.nodes)
        discovered[start] = True
        queue = deque([start])
        order = []
        while queue:
            node = queue.popleft()
            order.append(node)
            for succ in self.neighbors(node):
                if not discovered[succ]:
                    discovered[succ] = True
                    queue.append(succ)
        return order

    def topo_order(self, start: int) -> List[int]:
        """Kahn topological order with BFS-style FIFO tie-breaking.

        The reference executes a plain BFS (``runtime.rs:504-510``), which
        can visit a consumer before one of its producers in diamond graphs
        (e.g. an ERF aggregator discovered through a shallow contributor
        runs before the deeper forcing components have written, silently
        NaN-skipping their contributions).  Topological order preserves the
        BFS order for chain graphs and fixes the diamond case, so every
        component reads fully-written upstream outputs.
        """
        engine = self._native_engine()
        if engine is not None:
            return engine.topo_order(len(self.nodes), self._edge_pairs())
        indegree = [0] * len(self.nodes)
        for src, dst, _ in self.edges:
            if src != dst:
                indegree[dst] += 1
        queue = deque(
            node for node in range(len(self.nodes)) if indegree[node] == 0
        )
        order = []
        enqueued = [indegree[node] == 0 for node in range(len(self.nodes))]
        while queue:
            node = queue.popleft()
            order.append(node)
            for edge_idx in self._out[node]:
                _, dst, _ = self.edges[edge_idx]
                if dst == node:
                    continue
                indegree[dst] -= 1
                if indegree[dst] == 0 and not enqueued[dst]:
                    enqueued[dst] = True
                    queue.append(dst)
        return order

    def check_acyclic(self):
        """Raise on any cycle (self-loops tolerated, mirroring
        ``model/validation.rs:176`` which treats ``BackEdge(a, a)`` as OK)."""
        engine = self._native_engine()
        if engine is not None:
            offender = engine.find_cycle(len(self.nodes), self._edge_pairs())
            if offender >= 0:
                raise CircularDependencyError(
                    f"cycle passes through component "
                    f"'{getattr(self.nodes[offender], 'component_name', offender)}'"
                )
            return
        WHITE, GRAY, BLACK = 0, 1, 2
        color = [WHITE] * len(self.nodes)

        for root in range(len(self.nodes)):
            if color[root] != WHITE:
                continue
            stack = [(root, iter(self.neighbors(root)))]
            color[root] = GRAY
            while stack:
                node, it = stack[-1]
                advanced = False
                for succ in it:
                    if color[succ] == GRAY and succ != node:
                        raise CircularDependencyError(
                            f"cycle passes through component "
                            f"'{getattr(self.nodes[succ], 'component_name', succ)}'"
                        )
                    if color[succ] == WHITE:
                        color[succ] = GRAY
                        stack.append((succ, iter(self.neighbors(succ))))
                        advanced = True
                        break
                if not advanced:
                    color[node] = BLACK
                    stack.pop()

    def node_indices(self):
        return range(len(self.nodes))

    def __len__(self):
        return len(self.nodes)
