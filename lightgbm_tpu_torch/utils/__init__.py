from .log import (log_debug, log_info, log_warning, log_fatal,
                  register_log_callback, set_verbosity)
from .timer import global_timer, FunctionTimer
