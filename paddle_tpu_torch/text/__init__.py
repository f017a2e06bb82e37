"""``paddle.text`` (port of ``paddle_tpu/text``): Viterbi decoding and the
text datasets (parsers of local files)."""
from .datasets import (  # noqa: F401
    Imdb, Imikolov, UCIHousing, Conll05st, Movielens, WMT14, WMT16,
)
from .viterbi_decode import ViterbiDecoder, viterbi_decode  # noqa: F401

__all__ = ["UCIHousing", "Imdb", "Imikolov", "viterbi_decode",
           "Conll05st", "Movielens", "WMT14", "WMT16",
           "ViterbiDecoder"]
