from .compression import CODEC_NONE, CODEC_ZLIB, CODEC_ZSTD, codec_id, codec_name
from .dictionary import NULL_CODE, Dictionary, string_hash_token, string_hash_tokens
from .format import ChunkStats, StripeReader, read_stripe_footer, write_stripe
from .table_store import TableStore

__all__ = [
    "CODEC_NONE", "CODEC_ZLIB", "CODEC_ZSTD", "codec_id", "codec_name",
    "NULL_CODE", "Dictionary", "string_hash_token", "string_hash_tokens",
    "ChunkStats", "StripeReader", "read_stripe_footer", "write_stripe",
    "TableStore",
]
