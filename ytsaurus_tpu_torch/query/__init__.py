"""QL query engine: front end (lexer/parser/builder), typed IR, torch engine.

Port of the JAX package's `query/__init__.py`.
"""

from ytsaurus_tpu_torch.query.parser import parse_expression, parse_query  # noqa: F401
from ytsaurus_tpu_torch.query.builder import build_query  # noqa: F401
from ytsaurus_tpu_torch.query.engine.evaluator import Evaluator, select_rows  # noqa: F401
