"""Serving (counterpart of ``paddle_tpu/inference``). Ported: the dense
``ContinuousBatcher``, the ``PagedContinuousBatcher`` and the device tier of
the radix prefix cache."""
from .prefix_cache import RadixPrefixCache, chain_hashes
from .serving import ContinuousBatcher, PagedContinuousBatcher, Request

__all__ = ["ContinuousBatcher", "PagedContinuousBatcher", "RadixPrefixCache",
           "Request", "chain_hashes"]
