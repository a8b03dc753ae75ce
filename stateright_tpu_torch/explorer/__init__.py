"""Explorer: interactive state-space browser over the on-demand checker.

Counterpart of stateright src/checker/explorer.rs + ui/: an HTTP server
exposing ``GET /.status``, ``GET /.states/{fp[/fp...]}`` and
``POST /.runtocompletion``, plus a small single-page UI for stepping
through the state graph.
"""

from .server import serve, state_views, status_view

__all__ = ["serve", "state_views", "status_view"]
