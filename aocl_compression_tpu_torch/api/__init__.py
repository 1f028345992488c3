from .errors import CompressionError, ErrorCode  # noqa: F401
from .handle import Handle, Stats  # noqa: F401
from .registry import Method, get_codec, list_codecs  # noqa: F401
from .unified import (compress, compress_bound, decompress, destroy,  # noqa: F401
                      setup, version)
