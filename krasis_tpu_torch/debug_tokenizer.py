"""Debug tool: inspect what the tokenizer and chat template produce, the
port of ``krasis_tpu/debug_tokenizer.py`` (the quick first check when
generations look wrong for a new checkpoint).

    python -m krasis_tpu_torch.debug_tokenizer <model_path> [--prompt TEXT]

Prints the versions of Python and torch, the tokenizer class (the port's
own byte-level BPE, ``runtime/tokenizer.py``), its base vocabulary size,
whether a chat template is present, eos, the templated token ids and their
decode, and the plain encode's round trip: template bugs show up as
missing role markers or a broken round trip before any engine work.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m krasis_tpu_torch.debug_tokenizer",
                                 description=__doc__)
    ap.add_argument("model_path")
    ap.add_argument("--prompt", default="hello")
    ap.add_argument("--thinking", action="store_true",
                    help="enable_thinking=True in the template")
    args = ap.parse_args(argv)

    import torch

    print("torch:", torch.__version__)
    print("python:", sys.version.split()[0])
    print("model_path:", args.model_path)

    from .runtime.tokenizer import Tokenizer

    tok = Tokenizer(args.model_path)
    print("tokenizer class:", type(tok).__name__)
    print("vocab size:", len(tok.model.vocab))
    print("has chat_template:", bool(tok.chat_template))
    print("eos:", tok.eos_token_id, repr(tok.special_tokens.get("eos_token")))

    ids = tok.apply_chat_template([{"role": "user", "content": args.prompt}],
                                  enable_thinking=True if args.thinking else None)
    print("templated ids:", len(ids), "tokens; first 16:", ids[:16])
    print("decoded:", repr(tok.decode(ids))[:300])

    plain = tok.encode(args.prompt)
    print("plain encode:", plain)
    print("round trip:", repr(tok.decode(plain)))


if __name__ == "__main__":
    main()
