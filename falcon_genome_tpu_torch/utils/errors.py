"""Typed exceptions and the exception → CLI exit-code policy.

Mirrors the reference's typed exceptions (include/fcs-genome/common.h:27-66)
and its exit-code mapping (src/main.cpp:176-238):
helpRequest=0, invalidParam=1, options error=2, fileNotFound=3,
failedCommand=4, runtime_error=-1 (255 as an unsigned exit status).
"""
from __future__ import annotations


class FGError(Exception):
    """Base class for all falcon_genome_tpu errors."""


class HelpRequest(FGError):
    """User asked for help; not an error (exit 0)."""


class InvalidParam(FGError):
    def __init__(self, msg: str = ""):
        super().__init__(f"Invalid parameter: {msg}" if msg else "Invalid parameter")


class MissingParam(InvalidParam):
    def __init__(self, name: str):
        FGError.__init__(self, f"Missing required parameter: {name}")


class OptionsError(FGError):
    """Bad command-line syntax (boost::program_options::error analog)."""


class FileNotFound(FGError):
    def __init__(self, path: str):
        self.path = path
        super().__init__(f"Cannot find {path}")


class FilesNotFound(FileNotFound):
    def __init__(self, pattern: str):
        FGError.__init__(self, f"Cannot find files matching {pattern}")
        self.path = pattern


class FailedCommand(FGError):
    """A pipeline stage failed (exit 4 in the reference)."""


class InternalError(FGError):
    pass


class SilentExit(FGError):
    """Exit without an error banner (reference: silentExit)."""


EXIT_CODES = {
    HelpRequest: 0,
    SilentExit: 0,
    InvalidParam: 1,
    MissingParam: 1,
    OptionsError: 2,
    FileNotFound: 3,
    FilesNotFound: 3,
    FailedCommand: 4,
}


def exit_code_for(exc: BaseException) -> int:
    """Exit code for an exception per the reference's policy (main.cpp:176-238)."""
    for klass in type(exc).__mro__:
        if klass in EXIT_CODES:
            return EXIT_CODES[klass]
    return 255  # runtime_error → -1 in the reference
