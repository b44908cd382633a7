from .gtm import (
    GTMCommand, GTMHeader, GTMKeyFrameInfo, GTMWriter, parse_gtm,
    read_gts, write_gts,
)
from .lzma_codec import lzma_compress_alone, lzma_decompress_concat

__all__ = [
    'GTMCommand', 'GTMHeader', 'GTMKeyFrameInfo', 'GTMWriter', 'parse_gtm',
    'read_gts', 'write_gts', 'lzma_compress_alone', 'lzma_decompress_concat',
]
