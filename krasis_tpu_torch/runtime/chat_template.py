"""Chat-template rendering as transformers renders it.

``transformers.utils.chat_template_utils`` compiles a model's
``chat_template`` in a jinja2 ``ImmutableSandboxedEnvironment`` with
``trim_blocks`` and ``lstrip_blocks``, the ``loopcontrols`` extension and
a ``{% generation %}`` block tag, its own ``tojson`` filter (no HTML
escaping, non-ASCII kept) and the globals ``raise_exception`` and
``strftime_now``, then renders it with ``messages``, ``tools=None``,
``documents=None``, ``add_generation_prompt`` and the tokenizer's special
tokens. This module does the same with jinja2, which PyTorch depends on.
"""

from __future__ import annotations

import functools
import json
from datetime import datetime
from typing import List

import jinja2
import jinja2.ext
import jinja2.nodes
from jinja2.sandbox import ImmutableSandboxedEnvironment


class GenerationBlock(jinja2.ext.Extension):
    """``{% generation %}…{% endgeneration %}`` renders its body (transformers
    marks the assistant's tokens with it; the text is unchanged)."""

    tags = {"generation"}

    def parse(self, parser):
        lineno = next(parser.stream).lineno
        body = parser.parse_statements(("name:endgeneration",), drop_needle=True)
        return jinja2.nodes.CallBlock(self.call_method("_body"), [], [], body).set_lineno(lineno)

    def _body(self, caller):
        return caller()


def raise_exception(message):
    raise jinja2.exceptions.TemplateError(message)


def tojson(x, ensure_ascii=False, indent=None, separators=None, sort_keys=False):
    return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent, separators=separators,
                      sort_keys=sort_keys)


def strftime_now(format):  # noqa: A002 (transformers' name)
    return datetime.now().strftime(format)


@functools.lru_cache(maxsize=16)
def compile_template(source: str) -> jinja2.Template:
    env = ImmutableSandboxedEnvironment(trim_blocks=True, lstrip_blocks=True,
                                        extensions=[GenerationBlock, jinja2.ext.loopcontrols])
    env.filters["tojson"] = tojson
    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = strftime_now
    return env.from_string(source)


def render(source: str, messages: List[dict], add_generation_prompt: bool = False,
           **kwargs) -> str:
    return compile_template(source).render(messages=messages, tools=None, documents=None,
                                           add_generation_prompt=add_generation_prompt,
                                           **kwargs)
