"""The benchmark's CPU tests (``gfbench/tests``), collected here so that
the repository's test run counts them; each test runs as it does in its
own module. The card's tests (marker ``cuda``) stay in their modules:
``python -m pytest --noconftest -m cuda gfbench/tests -q`` on the card."""

from gfbench.tests.test_gfbench_bpmf import *  # noqa: F401,F403
from gfbench.tests.test_gfbench_counts import *  # noqa: F401,F403
from gfbench.tests.test_gfbench_faults import *  # noqa: F401,F403
from gfbench.tests.test_gfbench_files import *  # noqa: F401,F403
from gfbench.tests.test_gfbench_kinds import *  # noqa: F401,F403
from gfbench.tests.test_gfbench_modules import *  # noqa: F401,F403
from gfbench.tests.test_gfbench_nocard import *  # noqa: F401,F403
from gfbench.tests.test_gfbench_reference import *  # noqa: F401,F403
from gfbench.tests.test_gfbench_spans import *  # noqa: F401,F403
