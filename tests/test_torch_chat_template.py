"""Chat templates through the port's tokenizer against the reference's
``Tokenizer.apply_chat_template`` (transformers' jinja2 rendering, then
encoding without special tokens): identical ids.

Templates: the one of tests/test_e2e_checkpoint.py; a ChatML template with
Qwen3's thinking switch, whitespace control, ``namespace`` and reversed
loops; one with ``tojson``, ``raise_exception``, ``strftime_now``, loop
controls and a ``{% generation %}`` block; and one that raises TypeError
when given ``enable_thinking`` (the reference retries without it)."""

import json
import shutil

import jinja2
import pytest

from krasis_tpu.runtime.tokenizer import Tokenizer as RefTokenizer
from krasis_tpu_torch.runtime.tokenizer import Tokenizer

from torch_tokenizer_util import COMMITTED

E2E_TEMPLATE = (
    "{% for message in messages %}"
    "{{ '<|' + message['role'] + '|>' + message['content'] }}"
    "{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|assistant|>' }}{% endif %}"
)

QWEN3_TEMPLATE = """{%- if messages[0].role == 'system' %}
    {{- '<|im_start|>system\\n' + messages[0].content + '<|im_end|>\\n' }}
{%- endif %}
{%- set ns = namespace(multi_step_tool=true, last_query_index=messages|length - 1) %}
{%- for message in messages[::-1] %}
    {%- set index = (messages|length - 1) - loop.index0 %}
    {%- if ns.multi_step_tool and message.role == "user" %}
        {%- set ns.multi_step_tool = false %}
        {%- set ns.last_query_index = index %}
    {%- endif %}
{%- endfor %}
{%- for message in messages %}
    {%- if message.content is string %}
        {%- set content = message.content %}
    {%- else %}
        {%- set content = '' %}
    {%- endif %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) %}
        {{- '<|im_start|>' + message.role + '\\n' + content + '<|im_end|>' + '\\n' }}
    {%- elif message.role == "assistant" %}
        {%- set reasoning_content = '' %}
        {%- if '</think>' in content %}
            {%- set reasoning_content = content.split('</think>')[0].rstrip('\\n').split('<think>')[-1].lstrip('\\n') %}
            {%- set content = content.split('</think>')[-1].lstrip('\\n') %}
        {%- endif %}
        {%- if loop.index0 > ns.last_query_index %}
            {{- '<|im_start|>' + message.role + '\\n<think>\\n' + reasoning_content.strip('\\n') + '\\n</think>\\n\\n' + content.lstrip('\\n') }}
        {%- else %}
            {{- '<|im_start|>' + message.role + '\\n' + content }}
        {%- endif %}
        {{- '<|im_end|>\\n' }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
    {%- if enable_thinking is defined and enable_thinking is false %}
        {{- '<think>\\n\\n</think>\\n\\n' }}
    {%- endif %}
{%- endif %}"""

TOOLS_TEMPLATE = """{{ bos_token or '' }}{% for message in messages %}
{% if message['role'] not in ['system', 'user', 'assistant'] %}
{{ raise_exception('Unknown role: ' + message['role']) }}
{% endif %}
{% if message['role'] == 'system' and not loop.first %}{% continue %}{% endif %}
[{{ message['role'] | upper }}] {{ message['content'] | trim }}
{% if message.get('meta') %}meta={{ message['meta'] | tojson }}
{% endif %}
{% if message['content'] == 'STOP' %}{% break %}{% endif %}
{% endfor %}
{% if add_generation_prompt %}{% generation %}[ASSISTANT] {{ eos_token }}{% endgeneration %}{% endif %}
year {{ strftime_now('%Y') }}"""

TYPE_ERROR_TEMPLATE = (
    "{{ enable_thinking | length }}{% for m in messages %}<|im_start|>{{ m['content'] }}"
    "<|im_end|>{% endfor %}")

TEMPLATES = {"e2e": E2E_TEMPLATE, "qwen3": QWEN3_TEMPLATE, "tools": TOOLS_TEMPLATE,
             "type_error": TYPE_ERROR_TEMPLATE}

CONVERSATIONS = [
    [{"role": "user", "content": "Explain the os module."}],
    [{"role": "system", "content": "You are terse."},
     {"role": "user", "content": "hi 😀 漢字"},
     {"role": "assistant", "content": "<think>\nthe user greets\n</think>\n\nHello!"},
     {"role": "user", "content": "  and again  "}],
    [{"role": "user", "content": "first", "meta": {"lang": "français", "n": [1, 2]}},
     {"role": "system", "content": "late system"},
     {"role": "assistant", "content": "STOP"},
     {"role": "user", "content": "never shown"}],
]


def _dir(tmp_path, template, as_list=False):
    shutil.copy(f"{COMMITTED}/tokenizer.json", tmp_path / "tokenizer.json")
    cfg = json.load(open(f"{COMMITTED}/tokenizer_config.json"))
    cfg["chat_template"] = ([{"name": "tool_use", "template": "unused"},
                             {"name": "default", "template": template}] if as_list else template)
    cfg["bos_token"] = "<|endoftext|>"
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(cfg))
    return str(tmp_path)


@pytest.mark.parametrize("thinking", [None, True, False])
@pytest.mark.parametrize("name", list(TEMPLATES))
def test_template_ids_match_reference(tmp_path, name, thinking):
    path = _dir(tmp_path, TEMPLATES[name])
    port, ref = Tokenizer(path), RefTokenizer(path)
    for conv in CONVERSATIONS:
        want = ref.apply_chat_template(conv, enable_thinking=thinking)
        assert port.apply_chat_template(conv, enable_thinking=thinking) == want, conv
        assert port.decode(want) == ref.decode(want)


def test_named_template_list(tmp_path):
    """tokenizer_config.json may hold a list of named templates: "default"
    is the one applied."""
    path = _dir(tmp_path, QWEN3_TEMPLATE, as_list=True)
    conv = CONVERSATIONS[1]
    assert Tokenizer(path).apply_chat_template(conv) == RefTokenizer(path).apply_chat_template(
        conv)


def test_raise_exception_as_reference(tmp_path):
    path = _dir(tmp_path, TOOLS_TEMPLATE)
    bad = [{"role": "tool", "content": "x"}]
    with pytest.raises(jinja2.exceptions.TemplateError, match="Unknown role: tool") as want:
        RefTokenizer(path).apply_chat_template(bad)
    with pytest.raises(jinja2.exceptions.TemplateError) as got:
        Tokenizer(path).apply_chat_template(bad)
    assert str(got.value) == str(want.value)


def test_sandbox_refuses_unsafe_access(tmp_path):
    """The environment is jinja2's immutable sandbox, as transformers'."""
    path = _dir(tmp_path, "{{ messages.append(1) }}{{ ''.__class__.__mro__ }}")
    with pytest.raises(jinja2.exceptions.SecurityError):
        Tokenizer(path).apply_chat_template(CONVERSATIONS[0])
