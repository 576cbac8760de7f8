from .server import CoordinatorServer
from .client import Client

__all__ = ["CoordinatorServer", "Client"]
