"""Operators and lazy expressions — the untyped execution units stored in graph nodes.

Mirrors the behavioral contract of the reference's Operator/Expression layer
(reference: src/main/scala/keystoneml/workflow/Operator.scala:10-177,
Expression.scala:9-44): an operator consumes a sequence of expressions and
produces an expression; expressions are lazy, memoized thunks so that nothing
computes until a sink's value is demanded.

Dataset payloads here are :class:`keystone_tpu_torch.data.Dataset` values
(device tensors or host object collections) instead of RDDs.

Port of ``keystone_tpu/workflow/operators.py``; only the import paths
changed.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence


class Expression:
    """A lazy, memoized result of executing an operator."""

    def __init__(self, thunk: Callable[[], Any]):
        self._thunk = thunk
        self._computed = False
        self._value: Any = None

    def get(self) -> Any:
        if not self._computed:
            self._value = self._thunk()
            self._computed = True
            self._thunk = None  # free captured inputs once computed
        return self._value


class DatasetExpression(Expression):
    """Expression whose value is a Dataset (the RDD analog)."""


class DatumExpression(Expression):
    """Expression whose value is a single datum."""


class TransformerExpression(Expression):
    """Expression whose value is a fitted TransformerOperator."""


class Operator:
    """Base class for all graph operators.

    Equality/hash default to object identity; node-library operators that are
    deterministic functions of their constructor parameters override
    ``signature`` (or are dataclasses) to enable common-subexpression
    elimination and prefix-based state reuse across pipelines.
    """

    @property
    def label(self) -> str:
        return type(self).__name__

    def execute(self, deps: Sequence[Expression]) -> Expression:
        raise NotImplementedError


class DatasetOperator(Operator):
    """Zero-input operator that always emits a fixed dataset (Operator.scala:25-38)."""

    def __init__(self, dataset: Any):
        self.dataset = dataset

    @property
    def label(self) -> str:
        return f"Dataset[{type(self.dataset).__name__}]"

    def execute(self, deps: Sequence[Expression]) -> DatasetExpression:
        if deps:
            raise ValueError("DatasetOperator does not take any inputs")
        ds = self.dataset
        return DatasetExpression(lambda: ds)

    # Two wrappers of the same dataset object are the same logical operator
    # (the analog of case-class equality over an RDD reference), enabling
    # prefix-state reuse across pipelines built over the same data.
    def __eq__(self, other: object) -> bool:
        return type(other) is DatasetOperator and other.dataset is self.dataset

    def __hash__(self) -> int:
        return id(self.dataset)


class DatumOperator(Operator):
    """Zero-input operator that always emits a fixed single datum (Operator.scala:41-56)."""

    def __init__(self, datum: Any):
        self.datum = datum

    @property
    def label(self) -> str:
        return f"Datum[{type(self.datum).__name__}]"

    def execute(self, deps: Sequence[Expression]) -> DatumExpression:
        if deps:
            raise ValueError("DatumOperator does not take any inputs")
        datum = self.datum
        return DatumExpression(lambda: datum)

    def __eq__(self, other: object) -> bool:
        return type(other) is DatumOperator and other.datum is self.datum

    def __hash__(self) -> int:
        return id(self.datum)


def _split_deps(deps: Sequence[Expression]):
    """Validate that deps are homogeneous (all dataset or all datum)."""
    if not deps:
        raise ValueError("Transformer dependencies may not be empty")
    all_ds = all(isinstance(d, DatasetExpression) for d in deps)
    all_datum = all(isinstance(d, DatumExpression) for d in deps)
    if not (all_ds or all_datum):
        raise ValueError(
            "Transformer dependencies must be either all datasets or all single data items"
        )
    return all_ds


class TransformerOperator(Operator):
    """Operator that maps datums->datum and datasets->dataset (Operator.scala:66-100).

    Subclasses implement ``single_transform`` (a sequence of datum values to a
    value) and ``batch_transform`` (a sequence of Dataset values to a Dataset).
    Execution is lazy.
    """

    def single_transform(self, inputs: Sequence[Any]) -> Any:
        raise NotImplementedError

    def batch_transform(self, inputs: Sequence[Any]) -> Any:
        raise NotImplementedError

    def execute(self, deps: Sequence[Expression]) -> Expression:
        if _split_deps(deps):
            return DatasetExpression(lambda: self.batch_transform([d.get() for d in deps]))
        return DatumExpression(lambda: self.single_transform([d.get() for d in deps]))


class EstimatorOperator(Operator):
    """Operator producing a fitted TransformerOperator from datasets (Operator.scala:112-125)."""

    def fit_datasets(self, inputs: Sequence[Any]) -> TransformerOperator:
        raise NotImplementedError

    def execute(self, deps: Sequence[Expression]) -> TransformerExpression:
        if not all(isinstance(d, DatasetExpression) for d in deps):
            raise ValueError("Estimator dependencies must all be datasets")
        return TransformerExpression(lambda: self.fit_datasets([d.get() for d in deps]))


class DelegatingOperator(Operator):
    """Applies the fitted transformer from dep 0 to the remaining deps (Operator.scala:135-164)."""

    def execute(self, deps: Sequence[Expression]) -> Expression:
        if not deps:
            raise ValueError("DelegatingOperator dependencies may not be empty")
        transformer_expr = deps[0]
        rest = deps[1:]
        if not isinstance(transformer_expr, TransformerExpression):
            raise ValueError("DelegatingOperator's first dependency must be a transformer")
        if _split_deps(rest):
            return DatasetExpression(
                lambda: transformer_expr.get().batch_transform([d.get() for d in rest])
            )
        return DatumExpression(
            lambda: transformer_expr.get().single_transform([d.get() for d in rest])
        )


class ExpressionOperator(Operator):
    """Zero-input operator wrapping an already-computed expression (Operator.scala:172-177).

    Used by the saved-state-load rule to splice previously computed results
    (fitted transformers, cached datasets) back into a graph.
    """

    def __init__(self, expression: Expression, label: Optional[str] = None):
        self.expression = expression
        self._label = label

    @property
    def label(self) -> str:
        return self._label or "Expression"

    def execute(self, deps: Sequence[Expression]) -> Expression:
        if deps:
            raise ValueError("ExpressionOperator does not take any inputs")
        return self.expression


class GatherTransformerOperator(TransformerOperator):
    """N-ary gather used by ``Pipeline.gather`` (GatherTransformerOperator.scala:9-18).

    For datums: emits the tuple of branch values. For datasets: emits a Dataset
    whose per-item value is the tuple of the branches' per-item values (the
    array-world analog of zip-then-concat).
    """

    def single_transform(self, inputs: Sequence[Any]) -> Any:
        return tuple(inputs)

    def batch_transform(self, inputs: Sequence[Any]) -> Any:
        from keystone_tpu_torch.data import Dataset

        return Dataset.gather(list(inputs))

    def __eq__(self, other: object) -> bool:
        return type(other) is GatherTransformerOperator

    def __hash__(self) -> int:
        return hash(GatherTransformerOperator)
