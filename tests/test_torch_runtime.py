"""dynamo_tpu_torch's discovery runtime held against dynamo_tpu's (JAX) on the
CPU: the same scenarios run on both packages' MemoryStore,
DistributedRuntime.detached and Client, and what they observe must be equal.
"""

import asyncio
import importlib
import random
from types import SimpleNamespace

import pytest

PACKAGES = ("dynamo_tpu", "dynamo_tpu_torch")


def _runtime_of(pkg: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{pkg}.runtime.{name}")  # noqa: E731
    return SimpleNamespace(discovery=mod("discovery"), component=mod("component"), client=mod("client"))


class _NamedEngine:
    """Streams which worker served the request, and the request back."""

    def __init__(self, name: str) -> None:
        self.name = name

    async def generate(self, request, context):
        yield {"worker": self.name, "echo": request}


async def _lease_revoke(m) -> dict:
    """A revoked lease deletes its keys, and a prefix watch sees it."""
    store = m.discovery.MemoryStore()
    lease = await store.create_lease(ttl=30.0)
    await store.put("a/1", b"x", lease_id=lease.id)
    await store.put("a/2", b"y", lease_id=lease.id)
    await store.put("a/3", b"z")
    events, primed = [], asyncio.Event()

    async def collect():
        async for ev in store.watch_prefix("a/"):
            events.append((ev.type.value, ev.key, ev.value))
            if len(events) == 3:
                primed.set()
            if len(events) == 5:
                return

    task = asyncio.create_task(collect())
    await asyncio.wait_for(primed.wait(), 5)
    await lease.revoke()
    await asyncio.wait_for(task, 5)
    left = await store.get_prefix("a/")
    with pytest.raises(KeyError):
        await store.put("a/4", b"w", lease_id=lease.id)
    await store.close()
    return {"events": events, "left": left}


async def _serve_workers(rt, names, *, lease_ttl=None):
    ep = rt.namespace("ns").component("backend").endpoint("generate")
    leases = []
    for name in names:
        lease = await (rt.store.create_lease(lease_ttl) if lease_ttl else rt.secondary_lease())
        await ep.serve(_NamedEngine(name), metadata={"name": name}, lease=lease)
        leases.append(lease)
    return ep, leases


async def _one(client, body, **kw) -> list:
    return [item async for item in client.generate(body, **kw)]


async def _picks(m) -> dict:
    """round_robin and random spread over three workers."""
    rt = m.component.DistributedRuntime.detached()
    ep, _ = await _serve_workers(rt, ["w0", "w1", "w2"])
    out = {}
    for mode in ("round_robin", "random"):
        client = ep.client(router_mode=mode)
        await client.wait_for_instances(count=3, timeout=5)
        random.seed(7)
        out[mode] = [(await _one(client, {"i": i}))[0]["worker"] for i in range(9)]
        await client.close()
    await rt.close()
    return out


async def _direct(m) -> dict:
    """direct routing reaches the named instance, and refuses an unknown one."""
    rt = m.component.DistributedRuntime.detached()
    ep, leases = await _serve_workers(rt, ["w0", "w1"])
    client = ep.client(router_mode="direct")
    await client.wait_for_instances(count=2, timeout=5)
    got = [await _one(client, {"to": lease.id}, instance_id=lease.id) for lease in leases]
    with pytest.raises(m.client.NoInstancesError) as err:
        await _one(client, {}, instance_id=0x99)
    keys = sorted(await rt.store.get_prefix("instances/"))
    await client.close()
    await rt.close()
    return {"streams": got, "error": str(err.value), "keys": keys}


async def _lease_expiry(m) -> dict:
    """An instance whose lease ends leaves the client's table."""
    store = m.discovery.MemoryStore(reap_interval=0.05)
    rt = m.component.DistributedRuntime(store, None)
    ep, _ = await _serve_workers(rt, ["kept"])
    ep, short = await _serve_workers(rt, ["short-lived"], lease_ttl=0.3)
    client = ep.client()
    before = sorted(i.metadata["name"] for i in await client.wait_for_instances(count=2, timeout=5))
    for _ in range(100):
        if len(client.instance_ids()) == 1:
            break
        await asyncio.sleep(0.05)
    after = sorted(i.metadata["name"] for i in client.instances())
    served = [(await _one(client, {}))[0]["worker"] for _ in range(3)]
    gone = await store.get(m.component.instance_key("ns", "backend", "generate", short[0].id))
    await client.close()
    await rt.close()
    return {"before": before, "after": after, "served": served, "gone": gone}


SCENARIOS = {"lease_revoke": _lease_revoke, "picks": _picks, "direct": _direct, "lease_expiry": _lease_expiry}
EXPECT = {
    "lease_revoke": lambda r: r["left"] == {"a/3": b"z"} and r["events"][3:] == [
        ("delete", "a/1", None), ("delete", "a/2", None)],
    "picks": lambda r: len(set(r["round_robin"][:3])) == 3 and r["round_robin"][:3] == r["round_robin"][3:6],
    "direct": lambda r: [s[0]["worker"] for s in r["streams"]] == ["w0", "w1"] and "99" in r["error"],
    "lease_expiry": lambda r: r["before"] == ["kept", "short-lived"] and r["after"] == ["kept"]
    and r["served"] == ["kept"] * 3 and r["gone"] is None,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
async def test_runtime_scenario_observes_what_jax_observes(scenario):
    results = [await SCENARIOS[scenario](_runtime_of(pkg)) for pkg in PACKAGES]
    assert EXPECT[scenario](results[0]), results[0]  # the scenario did what it claims
    assert results[1] == results[0]
