"""Micropayment channels (§3.2): unidirectional client->server channels.

Faithful to the paper's description (which follows the classic Bitcoin
rapidly-adjusted micropayments contract [14]):

* open: funds move into a 2-of-2 multisig; server hands the client an initial
  *refund transaction* (full amount back to client, settle-time T0).
* pay: the client signs a new refund with a *smaller* refund amount and a
  *slightly earlier* allowed settlement time; the server keeps the latest.
* settle: either party broadcasts; the most recently signed refund (earliest
  valid settle time / highest paid amount) wins.

Signatures are HMAC stubs (this is a protocol simulation, not a wallet), but
the *state-machine safety properties* the paper relies on are enforced and
tested: payments are monotone, can never exceed the deposit, a stale refund
can never beat a fresher one, and an uncooperative party loses at most the
last unpaid increment ("value at risk is small").

Used in two places, exactly as in §2: client->RPC channels (SDK) and
RPC->SP channels (read path, one per SP).
"""
from __future__ import annotations

import dataclasses
import hashlib
import hmac
import itertools

_ids = itertools.count()


class ChannelError(Exception):
    pass


@dataclasses.dataclass(frozen=True)
class RefundTx:
    channel_id: int
    refund_amount: float  # what flows BACK to the client at settlement
    settle_time: float  # earliest time this refund may be enforced
    seq: int
    sig_client: bytes
    sig_server: bytes


def _sign(key: bytes, payload: str) -> bytes:
    return hmac.new(key, payload.encode(), hashlib.sha256).digest()


class MicropaymentChannel:
    """Unidirectional channel; amounts in abstract $ (paper: ~1e-9 / payment)."""

    def __init__(self, deposit: float, initial_settle_time: float = 1e9):
        if deposit <= 0:
            raise ChannelError("deposit must be positive")
        self.channel_id = next(_ids)
        self.deposit = float(deposit)
        self._client_key = hashlib.sha256(f"c{self.channel_id}".encode()).digest()
        self._server_key = hashlib.sha256(f"s{self.channel_id}".encode()).digest()
        self._seq = 0
        self._settle_time = initial_settle_time
        self.latest_refund = self._make_refund(deposit, initial_settle_time, 0)
        self.settled = False
        self.paid = 0.0

    def _make_refund(self, refund_amount: float, settle_time: float, seq: int) -> RefundTx:
        payload = f"{self.channel_id}:{refund_amount:.12f}:{settle_time}:{seq}"
        return RefundTx(
            channel_id=self.channel_id,
            refund_amount=refund_amount,
            settle_time=settle_time,
            seq=seq,
            sig_client=_sign(self._client_key, payload),
            sig_server=_sign(self._server_key, payload),
        )

    def pay(self, amount: float) -> RefundTx:
        """Client pays `amount` more; returns the fresh refund the server keeps."""
        if self.settled:
            raise ChannelError("channel settled")
        if amount <= 0:
            raise ChannelError("payment must be positive")
        if self.paid + amount > self.deposit + 1e-12:
            raise ChannelError("payment exceeds deposit")
        self.paid += amount
        self._seq += 1
        self._settle_time -= 1.0  # "slightly earlier allowed settlement time"
        self.latest_refund = self._make_refund(
            self.deposit - self.paid, self._settle_time, self._seq
        )
        return self.latest_refund

    def verify_refund(self, tx: RefundTx) -> bool:
        payload = f"{tx.channel_id}:{tx.refund_amount:.12f}:{tx.settle_time}:{tx.seq}"
        return (
            tx.channel_id == self.channel_id
            and hmac.compare_digest(tx.sig_client, _sign(self._client_key, payload))
            and hmac.compare_digest(tx.sig_server, _sign(self._server_key, payload))
        )

    def settle(self, tx: RefundTx) -> tuple[float, float]:
        """Enforce a refund tx; returns (client_gets, server_gets).

        The channel accepts only the *freshest* refund it has co-signed: a
        stale tx (lower seq) is rejected because the newer one has an earlier
        settle time and would preempt it on-chain.
        """
        if self.settled:
            raise ChannelError("already settled")
        if not self.verify_refund(tx):
            raise ChannelError("bad signature")
        if tx.seq < self.latest_refund.seq:
            raise ChannelError("stale refund preempted by a fresher one")
        self.settled = True
        client_gets = tx.refund_amount
        return client_gets, self.deposit - client_gets


class PaymentLedger:
    """Aggregates read payments across channels (RPC->SP or client->RPC)."""

    def __init__(self):
        self.channels: dict[str, MicropaymentChannel] = {}
        self.totals: dict[str, float] = {}

    def open(self, peer: str, deposit: float) -> MicropaymentChannel:
        ch = MicropaymentChannel(deposit)
        self.channels[peer] = ch
        self.totals.setdefault(peer, 0.0)
        return ch

    def pay(self, peer: str, amount: float) -> RefundTx:
        ch = self.channels[peer]
        tx = ch.pay(amount)
        self.totals[peer] += amount
        return tx

    def total_paid(self) -> float:
        # sorted so the float sum is independent of channel insertion order
        return sum(self.totals[k] for k in sorted(self.totals))
