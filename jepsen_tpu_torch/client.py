"""Client protocol (reference: jepsen/src/jepsen/client.clj:9-126).

A client applies operations to the system under test.  Lifecycle:

- ``open(test, node)``  → a client bound to one node (returns self or a
  fresh instance; called once per process)
- ``setup(test)``       → one-time data setup
- ``invoke(test, op)``  → apply an op dict, return the completion dict
  (type "ok", "fail", or "info")
- ``teardown(test)``
- ``close(test)``       → release connections

``reusable(test)`` — if True, the same client instance is kept across
process crashes instead of being reopened (reference: client.clj:29-44).
"""

from __future__ import annotations

from typing import Any, Optional


class Client:
    def open(self, test: dict, node: Any) -> "Client":
        return self

    def setup(self, test: dict) -> None:
        pass

    def invoke(self, test: dict, op: dict) -> dict:
        raise NotImplementedError

    def teardown(self, test: dict) -> None:
        pass

    def close(self, test: dict) -> None:
        pass

    def reusable(self, test: dict) -> bool:
        return False


class NoopClient(Client):
    """Does nothing but complete ops successfully.
    (reference: client.clj:46-62 noop)"""

    def invoke(self, test, op):
        return {**op, "type": "ok"}

    def reusable(self, test):
        return True


def noop() -> Client:
    return NoopClient()


class ValidationError(Exception):
    pass


class Validate(Client):
    """Wraps a client, validating the well-formedness of invocation
    results.  (reference: client.clj:64-109)"""

    def __init__(self, client: Client):
        self.client = client

    def open(self, test, node):
        opened = self.client.open(test, node)
        if opened is None:
            raise ValidationError(
                f"Expected client open to return a client, got None from "
                f"{self.client!r}"
            )
        return Validate(opened)

    def setup(self, test):
        self.client.setup(test)

    def invoke(self, test, op):
        res = self.client.invoke(test, op)
        problems = []
        if not isinstance(res, dict):
            problems.append(f"should return an op dict, got {res!r}")
        else:
            if res.get("type") not in ("ok", "fail", "info"):
                problems.append(
                    f":type should be ok, fail, or info, got {res.get('type')!r}"
                )
            if res.get("process") != op.get("process"):
                problems.append(
                    f":process {res.get('process')!r} != invoked {op.get('process')!r}"
                )
            if res.get("f") != op.get("f"):
                problems.append(
                    f":f {res.get('f')!r} != invoked {op.get('f')!r}"
                )
        if problems:
            raise ValidationError(
                f"Client {self.client!r} returned an invalid completion for "
                f"{op!r}: " + "; ".join(problems)
            )
        return res

    def teardown(self, test):
        self.client.teardown(test)

    def close(self, test):
        self.client.close(test)

    def reusable(self, test):
        return self.client.reusable(test)


def validate(client: Client) -> Client:
    return Validate(client)


def is_reusable(client: Optional[Client], test: dict) -> bool:
    return client is not None and client.reusable(test)
