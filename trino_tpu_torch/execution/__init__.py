"""Query lifecycle, admission control, and session configuration.

The coordinator control-plane layer of the reference (io/trino/execution,
io/trino/dispatcher, io/trino/execution/resourcegroups), re-hosted around the
single-process TPU engine: queries still move through the same state machine,
resource-group admission, and event/tracing hooks — the pieces a drop-in user
expects to observe and configure.
"""

from .query_state import QueryInfo, QueryState, QueryStateMachine, QueryTracker
from .resourcegroups import ResourceGroup, ResourceGroupManager
from .session_properties import SessionPropertyManager, SYSTEM_SESSION_PROPERTIES
from .statemachine import StateMachine

__all__ = [
    "QueryInfo", "QueryState", "QueryStateMachine", "QueryTracker",
    "ResourceGroup", "ResourceGroupManager",
    "SessionPropertyManager", "SYSTEM_SESSION_PROPERTIES",
    "StateMachine",
]
