"""Model builders."""
from .gpt2 import GPT2Config, build_gpt2  # noqa: F401
