"""The tokenizer of the port's LLM tests, in a module of its own: a worker
process that unpickles a config holding it imports only this file, not a
test module's JAX and torch imports."""


class IdsTokenizer:
    """ByteTokenizer's encode; decode writes the ids out, so a completion's
    text carries its exact tokens (random weights rarely emit byte ids)."""

    vocab_size = 257
    eos_token_id = 256

    def encode(self, text):
        return list(text.encode("utf-8"))

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)
