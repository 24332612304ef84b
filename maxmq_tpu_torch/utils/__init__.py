"""Host utilities: snowflake IDs, structured logging, config, build info,
and the stream framing shared by the port's modules."""

from .build import BuildInfo, get_info
from .config import Config, load_config, read_config_file
from .logger import Logger, new_logger
from .snowflake import Snowflake

__all__ = ["Snowflake", "Logger", "new_logger", "Config", "load_config",
           "read_config_file", "get_info", "BuildInfo"]
