"""Default graph-storage backend: a mutable bipartite factor graph.

The analogue of the reference's ``BipartiteFactorGraphs.jl`` backend
wired through ``ext/BipartiteFactorGraphsExt/BipartiteFactorGraphsExt.jl:16-50``.
Variables and factors share a single integer ID space (IDs are unique across
both), adjacency is stored as per-node ID lists in insertion order, and each
(variable, factor) pair carries one :class:`~cortex_tpu_torch.core.model_engine.Connection`.

This is the graph users construct models with before handing the graph to the
:class:`~cortex_tpu_torch.core.engine.InferenceEngine` (dynamic path) or to the static
schedule compiler (:mod:`cortex_tpu_torch.compile`).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .model_engine import Connection, Factor, Variable

__all__ = ["BipartiteFactorGraph"]


class BipartiteFactorGraph:
    """Mutable bipartite factor graph with Variable/Factor/Connection payloads."""

    __cortex_engine_supported__ = True

    def __init__(self) -> None:
        self._next_id = 1
        self._variables: Dict[int, Variable] = {}
        self._factors: Dict[int, Factor] = {}
        self._connections: Dict[Tuple[int, int], Connection] = {}
        self._variable_neighbors: Dict[int, List[int]] = {}
        self._factor_neighbors: Dict[int, List[int]] = {}

    # -- construction -----------------------------------------------------
    def add_variable(self, variable: Variable) -> int:
        vid = self._next_id
        self._next_id += 1
        self._variables[vid] = variable
        self._variable_neighbors[vid] = []
        return vid

    def add_factor(self, factor: Factor) -> int:
        fid = self._next_id
        self._next_id += 1
        self._factors[fid] = factor
        self._factor_neighbors[fid] = []
        return fid

    def add_edge(self, variable_id: int, factor_id: int, connection: Connection) -> None:
        if variable_id not in self._variables:
            raise KeyError(f"Unknown variable id {variable_id}")
        if factor_id not in self._factors:
            raise KeyError(f"Unknown factor id {factor_id}")
        key = (variable_id, factor_id)
        if key in self._connections:
            raise ValueError(
                f"Edge between variable {variable_id} and factor {factor_id} "
                "already exists"
            )
        self._connections[key] = connection
        self._variable_neighbors[variable_id].append(factor_id)
        self._factor_neighbors[factor_id].append(variable_id)

    # -- model-engine interface (reference src/model_engine.jl:329-391) ---
    def get_variable(self, variable_id: int) -> Variable:
        try:
            return self._variables[variable_id]
        except KeyError:
            raise KeyError(
                f"Unknown variable id {variable_id} (graph has "
                f"{self.num_variables()} variables; ids are shared with "
                "factors)"
            ) from None

    def get_factor(self, factor_id: int) -> Factor:
        try:
            return self._factors[factor_id]
        except KeyError:
            raise KeyError(
                f"Unknown factor id {factor_id} (graph has "
                f"{self.num_factors()} factors; ids are shared with variables)"
            ) from None

    def get_variable_ids(self):
        return self._variables.keys()

    def get_factor_ids(self):
        return self._factors.keys()

    def get_connection(self, variable_id: int, factor_id: int) -> Connection:
        try:
            return self._connections[(variable_id, factor_id)]
        except KeyError:
            raise KeyError(
                f"No edge between variable {variable_id} and factor "
                f"{factor_id}"
            ) from None

    def get_connected_variable_ids(self, factor_id: int):
        return self._factor_neighbors[factor_id]

    def get_connected_factor_ids(self, variable_id: int):
        return self._variable_neighbors[variable_id]

    # -- misc --------------------------------------------------------------
    def num_variables(self) -> int:
        return len(self._variables)

    def num_factors(self) -> int:
        return len(self._factors)

    def num_edges(self) -> int:
        return len(self._connections)

    def __repr__(self) -> str:
        return (
            f"BipartiteFactorGraph({self.num_variables()} variables, "
            f"{self.num_factors()} factors, {self.num_edges()} edges)"
        )
