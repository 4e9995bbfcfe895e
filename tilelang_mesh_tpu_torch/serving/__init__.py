"""Serving subsystem on the card: continuous batching over the CUDA
decode kernels (paged flash decode, or DeepSeek-MLA decode).

    from tilelang_mesh_tpu_torch.serving import (
        ServingEngine, FlashDecodeWorkload, PagedKVAllocator)

    alloc = PagedKVAllocator(n_pages=64, page_size=8, heads=2,
                             head_dim=64)            # device="cpu" too
    eng = ServingEngine(FlashDecodeWorkload(alloc, batch_buckets=(4,),
                                            page_buckets=(2, 4)))
    eng.warmup()                 # builds the kernel, launches each bucket
    r = eng.submit(context_tokens=16, new_tokens=2, deadline_ms=500)
    eng.run()                    # every request reaches a terminal outcome

    # MLA: a latent-major pool, one [ckv | kpe] row per token
    mla = PagedKVAllocator(n_pages=64, page_size=8, heads=1,
                           head_dim=32 + 16)
    eng = ServingEngine(MLADecodeWorkload(mla, heads=2, latent_dim=32,
                                          rope_dim=16))
"""

from .admission import (AdmissionController, SERVE_BREAKER_SIG,  # noqa: F401
                        STEP_HIST_KERNEL)
from .batcher import (DecodeWorkload, FlashDecodeWorkload,  # noqa: F401
                      MLADecodeWorkload)
from .engine import ServingEngine, TokenStream  # noqa: F401
from .kv_cache import (KVCacheExhausted, KVSnapshot,  # noqa: F401
                       PagedKVAllocator, allocator_from_reference)
from .prefix_cache import (PrefixEntry, PrefixKVCache,  # noqa: F401
                           get_prefix_cache, reset_prefix_cache)
from .request import (OUTCOMES, Request, SHED_REASONS, STATES,  # noqa: F401
                      default_prompt, gauges as serving_state,
                      reset_gauges)
from .sampling import sample_token  # noqa: F401

__all__ = [
    "ServingEngine", "TokenStream", "DecodeWorkload", "FlashDecodeWorkload",
    "MLADecodeWorkload",
    "PagedKVAllocator", "KVCacheExhausted", "KVSnapshot",
    "allocator_from_reference", "AdmissionController", "Request", "STATES",
    "OUTCOMES", "SHED_REASONS", "SERVE_BREAKER_SIG", "STEP_HIST_KERNEL",
    "serving_state", "reset_gauges", "default_prompt", "PrefixEntry",
    "PrefixKVCache", "get_prefix_cache", "reset_prefix_cache",
    "sample_token",
]
