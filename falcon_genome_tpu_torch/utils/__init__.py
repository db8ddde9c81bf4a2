"""Common utilities: typed errors, filesystem helpers, shard naming, timing.

TPU-native re-expression of the reference's L1 utils layer
(/root/reference/src/common.cpp, include/fcs-genome/common.h).
"""
from .errors import (
    FGError,
    FileNotFound,
    FilesNotFound,
    FailedCommand,
    InvalidParam,
    MissingParam,
    InternalError,
    SilentExit,
    HelpRequest,
    EXIT_CODES,
    exit_code_for,
)
from .common import (
    check_input,
    check_output,
    check_dir,
    create_dir,
    remove_path,
    get_input_list,
    get_contig_fname,
    get_bucket_fname,
    get_basename,
    get_basename_wo_ext,
    get_fname_by_ext,
    get_absolute_path,
    now_ts,
    Timer,
    log_time,
)
from .logutils import find_error

__all__ = [
    "FGError", "FileNotFound", "FilesNotFound", "FailedCommand",
    "InvalidParam", "MissingParam", "InternalError", "SilentExit",
    "HelpRequest", "EXIT_CODES", "exit_code_for",
    "check_input", "check_output", "check_dir", "create_dir", "remove_path",
    "get_input_list", "get_contig_fname", "get_bucket_fname",
    "get_basename", "get_basename_wo_ext", "get_fname_by_ext",
    "get_absolute_path", "now_ts", "Timer", "log_time", "find_error",
]
