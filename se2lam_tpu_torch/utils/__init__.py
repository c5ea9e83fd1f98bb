"""Host-side plumbing of the chunked and pipelined feeds, and stage timing
(port of se2lam_tpu.utils' ``chunking``, ``prefetch`` and ``timing``)."""
from .chunking import check_chunk, stack_images  # noqa: F401
from .prefetch import HostCopy, host_prefetch  # noqa: F401
from .timing import StageTimer, WorkTimer, device_trace, measure_rtt  # noqa: F401
