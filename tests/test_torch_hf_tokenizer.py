"""The port's HF tokenizer and chat templates against the JAX package's.

A tokenizer directory is built here with ``tokenizers`` (a word-level
model over a small vocabulary, saved as ``tokenizer.json`` with its
``tokenizer_config.json`` by ``transformers``), so nothing is fetched.
Both packages' ``HFTokenizer`` (through ``get_tokenizer(path)``) encode
and decode the same ids and text; ``render_chat_prompt`` gives the same
ids with an inline ``--chat-template``, with one read from a file (the
servers' loaders), with the model's own template and with none; and a
broken template fails at start-up in both servers' loaders, with the
same error type.
"""

import argparse

import pytest

from production_stack_tpu.engine import server as jax_server
from production_stack_tpu.engine import tokenizer as jax_tokenizer
from production_stack_tpu_torch.engine import server as port_server
from production_stack_tpu_torch.engine import tokenizer as port_tokenizer

WORDS = ["hello", "world", "the", "a", "cat", "sat", "on", "mat", "user",
         "assistant", "system", "says", ":", "|", "<", ">", "hi", "there"]
SPECIALS = ["[UNK]", "<s>", "</s>"]
MODEL_TEMPLATE = ("{% for m in messages %}{{ m['role'] }} : "
                  "{{ m['content'] }} | {% endfor %}"
                  "{% if add_generation_prompt %}assistant :{% endif %}")
OPERATOR_TEMPLATE = ("<s> {% for m in messages %}{{ m['content'] }} "
                     "says {{ m['role'] }} {% endfor %}</s>")
MESSAGES = [{"role": "system", "content": "the cat"},
            {"role": "user", "content": "hello world"}]


def write_tokenizer(path, vocab_size=None, chat_template=MODEL_TEMPLATE):
    """A word-level HF tokenizer directory at ``path`` (ids: the
    specials, then WORDS; padded with unused words to ``vocab_size``)."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast
    words = SPECIALS + WORDS
    if vocab_size is not None:
        words += [f"w{i}" for i in range(vocab_size - len(words))]
    tok = Tokenizer(models.WordLevel({w: i for i, w in enumerate(words)},
                                     unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok, bos_token="<s>",
                                   eos_token="</s>", unk_token="[UNK]")
    if chat_template is not None:
        fast.chat_template = chat_template
    fast.save_pretrained(str(path))
    return str(path)


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    return write_tokenizer(tmp_path_factory.mktemp("tok"))


@pytest.fixture(scope="module")
def both(tok_dir):
    return (port_tokenizer.get_tokenizer(tok_dir),
            jax_tokenizer.get_tokenizer(tok_dir))


def test_get_tokenizer_loads_the_directory(both):
    ours, theirs = both
    assert isinstance(ours, port_tokenizer.HFTokenizer)
    assert ours.eos_token_id == theirs.eos_token_id == 2
    assert ours.vocab_size == theirs.vocab_size == len(SPECIALS + WORDS)


@pytest.mark.parametrize("text", ["hello world", "the cat sat on the mat",
                                  "hi there unknown words", ""])
def test_encode_and_decode_match_jax(both, text):
    ours, theirs = both
    ids = ours.encode(text)
    assert ids == theirs.encode(text)
    assert ours.decode(ids) == theirs.decode(ids)
    assert ours.decode(ids + [2, 1]) == theirs.decode(ids + [2, 1])


def test_presets_keep_the_byte_tokenizers():
    assert isinstance(port_tokenizer.get_tokenizer(None),
                      port_tokenizer.ByteTokenizer)
    bench = port_tokenizer.get_tokenizer("bench")
    assert isinstance(bench, port_tokenizer.BenchTokenizer)
    # JAX's default vocab, whatever the model's.
    assert bench.vocab_size == jax_tokenizer.get_tokenizer(
        "bench").vocab_size == 32128


def _args(template):
    return argparse.Namespace(chat_template=template)


@pytest.mark.parametrize("where", ["inline", "file"])
def test_chat_template_gives_the_jax_ids(both, tmp_path, where):
    template = OPERATOR_TEMPLATE
    if where == "file":
        path = tmp_path / "template.jinja"
        path.write_text(OPERATOR_TEMPLATE)
        template = str(path)
    ours = port_server.load_chat_template(_args(template))
    theirs = jax_server._load_chat_template(_args(template))
    assert ours == theirs == OPERATOR_TEMPLATE
    port_tok, jax_tok = both
    got = port_tokenizer.render_chat_prompt(port_tok, MESSAGES,
                                            chat_template=ours)
    want = jax_tokenizer.render_chat_prompt(jax_tok, MESSAGES,
                                            chat_template=theirs)
    assert got == want
    # The template's own <s>: no second BOS from the encoding.
    assert got[0] == 1 and got.count(1) == 1


def test_model_template_and_fallback_give_the_jax_ids(both, tmp_path):
    port_tok, jax_tok = both
    got = port_tokenizer.render_chat_prompt(port_tok, MESSAGES)
    assert got == jax_tokenizer.render_chat_prompt(jax_tok, MESSAGES)
    assert got == port_tok.encode_rendered(
        "system : the cat | user : hello world | assistant :")
    plain = write_tokenizer(tmp_path / "plain", chat_template=None)
    port_plain = port_tokenizer.get_tokenizer(plain)
    jax_plain = jax_tokenizer.get_tokenizer(plain)
    assert (port_tokenizer.render_chat_prompt(port_plain, MESSAGES)
            == jax_tokenizer.render_chat_prompt(jax_plain, MESSAGES))
    byte_p, byte_j = (port_tokenizer.ByteTokenizer(),
                      jax_tokenizer.ByteTokenizer())
    for template in (None, OPERATOR_TEMPLATE):
        assert (port_tokenizer.render_chat_prompt(byte_p, MESSAGES,
                                                  template)
                == jax_tokenizer.render_chat_prompt(byte_j, MESSAGES,
                                                    template))


@pytest.mark.parametrize("template", ["{% if %}", "{{ messages[0].x.y }}"])
def test_a_broken_template_fails_at_start_up(template):
    import jinja2
    with pytest.raises(jinja2.TemplateError) as ours:
        port_server.load_chat_template(_args(template))
    with pytest.raises(jinja2.TemplateError) as theirs:
        jax_server._load_chat_template(_args(template))
    assert type(ours.value) is type(theirs.value)
    with pytest.raises(jinja2.TemplateError):
        port_server.make_server(["--device", "cpu", "--port", "0",
                                 "--chat-template", template])


def test_no_template_flag_is_none():
    assert port_server.load_chat_template(_args(None)) is None
    assert jax_server._load_chat_template(_args(None)) is None
