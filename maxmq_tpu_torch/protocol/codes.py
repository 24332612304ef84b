"""MQTT reason codes (v5) and their v3.1.1 CONNACK mappings.

Parity surface: vendor/github.com/mochi-co/mqtt/v2/packets/codes.go in the
reference (reason-code table and v5->v3 CONNACK downgrade). Re-derived from the
MQTT 3.1.1 / 5.0 specifications, not translated.

Copy of the JAX package's ``protocol/codes.py``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Code:
    """A reason code carried in acks/disconnects; failure when >= 0x80."""

    value: int
    reason: str = ""

    @property
    def is_error(self) -> bool:
        return self.value >= 0x80

    def __int__(self) -> int:  # convenience for encoders
        return self.value


# -- success codes -----------------------------------------------------------
Success = Code(0x00, "success")
GrantedQos0 = Code(0x00, "granted qos 0")
GrantedQos1 = Code(0x01, "granted qos 1")
GrantedQos2 = Code(0x02, "granted qos 2")
DisconnectWithWill = Code(0x04, "disconnect with will message")
NoMatchingSubscribers = Code(0x10, "no matching subscribers")
NoSubscriptionExisted = Code(0x11, "no subscription existed")
ContinueAuthentication = Code(0x18, "continue authentication")
ReAuthenticate = Code(0x19, "re-authenticate")

# -- error codes -------------------------------------------------------------
ErrUnspecifiedError = Code(0x80, "unspecified error")
ErrMalformedPacket = Code(0x81, "malformed packet")
ErrProtocolViolation = Code(0x82, "protocol error")
ErrImplementationSpecificError = Code(0x83, "implementation specific error")
ErrUnsupportedProtocolVersion = Code(0x84, "unsupported protocol version")
ErrClientIdentifierNotValid = Code(0x85, "client identifier not valid")
ErrBadUsernameOrPassword = Code(0x86, "bad username or password")
ErrNotAuthorized = Code(0x87, "not authorized")
ErrServerUnavailable = Code(0x88, "server unavailable")
ErrServerBusy = Code(0x89, "server busy")
ErrBanned = Code(0x8A, "banned")
ErrServerShuttingDown = Code(0x8B, "server shutting down")
ErrBadAuthenticationMethod = Code(0x8C, "bad authentication method")
ErrKeepAliveTimeout = Code(0x8D, "keep alive timeout")
ErrSessionTakenOver = Code(0x8E, "session taken over")
ErrTopicFilterInvalid = Code(0x8F, "topic filter invalid")
ErrTopicNameInvalid = Code(0x90, "topic name invalid")
ErrPacketIdentifierInUse = Code(0x91, "packet identifier in use")
ErrPacketIdentifierNotFound = Code(0x92, "packet identifier not found")
ErrReceiveMaximumExceeded = Code(0x93, "receive maximum exceeded")
ErrTopicAliasInvalid = Code(0x94, "topic alias invalid")
ErrPacketTooLarge = Code(0x95, "packet too large")
ErrMessageRateTooHigh = Code(0x96, "message rate too high")
ErrQuotaExceeded = Code(0x97, "quota exceeded")
ErrAdministrativeAction = Code(0x98, "administrative action")
ErrPayloadFormatInvalid = Code(0x99, "payload format invalid")
ErrRetainNotSupported = Code(0x9A, "retain not supported")
ErrQosNotSupported = Code(0x9B, "qos not supported")
ErrUseAnotherServer = Code(0x9C, "use another server")
ErrServerMoved = Code(0x9D, "server moved")
ErrSharedSubscriptionsNotSupported = Code(0x9E, "shared subscriptions not supported")
ErrConnectionRateExceeded = Code(0x9F, "connection rate exceeded")
ErrMaximumConnectTime = Code(0xA0, "maximum connect time")
ErrSubscriptionIdentifiersNotSupported = Code(0xA1, "subscription identifiers not supported")
ErrWildcardSubscriptionsNotSupported = Code(0xA2, "wildcard subscriptions not supported")

# Internal pseudo-codes (never sent on the wire) used by the broker runtime.
ErrPacketEmpty = Code(0xFE, "packet empty")
ErrInvalidPacketType = Code(0xFD, "invalid packet type")

# v5 reason code -> MQTT 3.1.1 CONNACK return code (spec table 3.1).
_V3_CONNACK = {
    ErrUnsupportedProtocolVersion.value: 0x01,
    ErrClientIdentifierNotValid.value: 0x02,
    ErrServerUnavailable.value: 0x03,
    ErrServerBusy.value: 0x03,
    ErrBadUsernameOrPassword.value: 0x04,
    ErrBadAuthenticationMethod.value: 0x04,
    ErrNotAuthorized.value: 0x05,
    ErrBanned.value: 0x05,
}


def connack_for_version(code: Code, protocol_version: int) -> int:
    """Downgrade a v5 CONNACK reason code for v3.x clients."""
    if protocol_version >= 5 or not code.is_error:
        return code.value
    return _V3_CONNACK.get(code.value, 0x03)
