"""The benchmark's own tests: the checkout's root and ``src`` on the path,
torch on one thread, and small cells that run on the CPU."""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
