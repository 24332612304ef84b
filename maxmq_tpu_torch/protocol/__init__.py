"""The slice of the MQTT protocol model the matcher service needs."""

from .packets import Subscription

__all__ = ["Subscription"]
