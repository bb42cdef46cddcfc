from vulkanraytracing_torch.utils.logging import log_d, log_e, log_i, log_t, log_w  # noqa: F401
from vulkanraytracing_torch.utils.timing import ScopeTime, Timer  # noqa: F401
