"""Safe condition-expression evaluator.

The reference parses conditional-variable activation strings with the
third-party `py_expression_eval` package (ref:
bayes_optim/search_space/variable.py:151-162). We implement the same
capability natively on Python's `ast` with a strict node whitelist — no
`eval` of arbitrary code, no attribute access, no calls.

Supported syntax: comparisons (== != < <= > >=), boolean and/or/not,
arithmetic (+ - * / % **), literals (numbers, strings, True/False/None),
`in` / `not in` over tuples/lists, and variable names. Variable names may be
written bare (``x == 2``) or backtick-quoted (``                `var 1` == 2``)
for names that are not valid identifiers.
"""
from __future__ import annotations

import ast
import re
from typing import Any, Dict, List

_BACKTICK = re.compile(r"`([^`]+)`")

_ALLOWED_NODES = (
    ast.Expression, ast.BoolOp, ast.UnaryOp, ast.BinOp, ast.Compare,
    ast.Name, ast.Load, ast.Constant, ast.Tuple, ast.List,
    ast.And, ast.Or, ast.Not, ast.USub, ast.UAdd,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod, ast.Pow, ast.FloorDiv,
    ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE, ast.In, ast.NotIn,
)


class ConditionExpression:
    """A parsed, validated condition expression.

    >>> e = ConditionExpression("`x` == 2 and y in ('a', 'b')")
    >>> sorted(e.variables())
    ['x', 'y']
    >>> e.evaluate({"x": 2, "y": "a"})
    True
    """

    def __init__(self, expression: str):
        self.source = expression
        self._placeholder_to_name: Dict[str, str] = {}

        def repl(m: "re.Match[str]") -> str:
            name = m.group(1)
            ph = f"__v{len(self._placeholder_to_name)}__"
            self._placeholder_to_name[ph] = name
            return ph

        normalized = _BACKTICK.sub(repl, expression)
        try:
            tree = ast.parse(normalized, mode="eval")
        except SyntaxError as exc:  # pragma: no cover - defensive
            raise ValueError(f"cannot parse condition {expression!r}: {exc}") from exc
        for node in ast.walk(tree):
            if not isinstance(node, _ALLOWED_NODES):
                raise ValueError(
                    f"disallowed syntax {type(node).__name__!r} in condition {expression!r}"
                )
        self._tree = tree
        self.normalized = normalized
        self._code = compile(tree, "<condition>", "eval")
        self._vars = [
            self._placeholder_to_name.get(n.id, n.id)
            for n in ast.walk(tree)
            if isinstance(n, ast.Name)
        ]

    def variables(self) -> List[str]:
        seen, out = set(), []
        for v in self._vars:
            if v not in seen:
                seen.add(v)
                out.append(v)
        return out

    def evaluate(self, values: Dict[str, Any]) -> Any:
        env = dict(values)
        for ph, name in self._placeholder_to_name.items():
            if name in values:
                env[ph] = values[name]
        return eval(self._code, {"__builtins__": {}}, env)  # noqa: S307 - whitelisted AST only


def evaluate_size(expr, dim: int) -> int:
    """Safe evaluator for budget/size strings like ``"5*dim"``.

    The reference runs raw ``eval()`` on user strings for DoE_size/max_FEs
    (ref: base.py:142-143, utils/utils.py:249-269) — SURVEY §7 lists that as
    a quirk NOT to replicate. This accepts the same convenience syntax
    through the whitelisted-AST ConditionExpression instead: arithmetic over
    the single variable ``dim``, nothing else (no attribute access, no
    calls, no builtins).
    """
    try:
        value = ConditionExpression(str(expr)).evaluate({"dim": int(dim)})
    except ValueError as exc:
        raise ValueError(
            f"cannot parse size expression {expr!r}: only arithmetic over "
            "the variable 'dim' is accepted (e.g. '5*dim', 'dim**2 // 2'); "
            "function calls and attribute access (like 'np.sqrt(dim)') are "
            "deliberately rejected — precompute such values in Python and "
            "pass the number"
        ) from exc
    return int(value)
