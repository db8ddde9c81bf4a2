"""The benchmark's own tests: its modules import from ``portbench/``,
and the program from the checkout's root."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
for p in (HERE.parent.parent, HERE.parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
