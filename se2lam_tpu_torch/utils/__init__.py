"""Host-side plumbing of the chunked and pipelined feeds (port of
se2lam_tpu.utils' ``chunking`` and ``prefetch``)."""
from .chunking import check_chunk, stack_images  # noqa: F401
from .prefetch import HostCopy, host_prefetch  # noqa: F401
