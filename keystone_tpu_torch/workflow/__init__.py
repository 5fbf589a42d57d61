"""Workflow layer: untyped DAG, lazy executor, optimizer, typed ML API
(port of ``keystone_tpu/workflow/__init__.py``)."""

from .analysis import get_ancestors, get_children, get_descendants, get_parents, linearize
from .env import PipelineEnv, Prefix
from .executor import GraphExecutor
from .graph import Graph, GraphError, NodeId, SinkId, SourceId
from .operators import (
    DatasetExpression,
    DatasetOperator,
    DatumExpression,
    DatumOperator,
    DelegatingOperator,
    EstimatorOperator,
    Expression,
    ExpressionOperator,
    GatherTransformerOperator,
    Operator,
    TransformerExpression,
    TransformerOperator,
)
from .optimizable import (
    OptimizableEstimator,
    OptimizableLabelEstimator,
    OptimizableTransformer,
)
from .optimizer import (
    AutoCachingOptimizer,
    Batch,
    DefaultOptimizer,
    FixedPoint,
    Once,
    Optimizer,
    Rule,
    RuleExecutor,
)
from .pipeline import (
    Chainable,
    Estimator,
    FittedPipeline,
    Identity,
    LabelEstimator,
    LambdaTransformer,
    Pipeline,
    PipelineDataset,
    PipelineDatum,
    PipelineResult,
    Transformer,
    TransformerGraph,
    transformer,
)
from .verify import (
    UNKNOWN,
    ArraySig,
    Finding,
    HostSig,
    PlanVerificationError,
    SignatureError,
    TransformerSig,
    TupleSig,
    VerifyReport,
    expect_host,
    verify_apply_graph,
    verify_fit_graph,
    verify_graph,
)
