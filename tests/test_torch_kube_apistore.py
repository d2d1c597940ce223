"""The API-backed store, the API client and the stub API server
(nos_tpu_torch.kube.apistore / apiclient, nos_tpu_torch.sim.apiserver)
against the reference's, across the wire on 127.0.0.1 (port 0).

One scenario runs in all four combinations of store and server (the
port's store on the reference's server, the reference's store on the
port's, each on its own): nodes and pods created, a pod bound (the
``binding`` subresource), a phase written (``/status``), labels patched,
a config map's merge patch retried on a conflict an outside writer
caused, an outside create, a stale ``update`` refused and a fresh one
taken, a delete; then every reflector's stream drops while the server
expires the versions it held (the next watch gets 410 Gone) and outside
writes land, and the reflectors relist. Each write makes one version, and
the test waits for every outside write to reach the cache, so the
deliveries are a function of the server's history. All four give the
same cached objects (the wire documents, less the uids and creation
times the servers stamp from their own counters and the wall clock) and
the same watch deliveries (type, kind, namespace, name, version); each
cache equals its server's objects.

The reference's own cases (tests/kube/test_apistore.py) run on the port's
store against both servers: read your writes, a no-op patch writes
nothing, unmodelled fields survive a patch, the client's conflict on a
stale PUT, its watch stream, the cache's indexers, and a kind the server
does not serve syncs empty.
"""
import threading
import time

import pytest

from nos_tpu.kube import apiclient as japiclient
from nos_tpu.kube import apistore as japistore
from nos_tpu.kube import serde as jserde
from nos_tpu.kube import store as jstore
from nos_tpu.sim import apiserver as japiserver
from nos_tpu_torch.kube import apiclient as tapiclient
from nos_tpu_torch.kube import apistore as tapistore
from nos_tpu_torch.kube import serde as tserde
from nos_tpu_torch.kube.objects import ConfigMap, Node, Pod
from nos_tpu_torch.kube.store import ConflictError, NotFoundError
from nos_tpu_torch.sim import apiserver as tapiserver
from tests.torch_kube_cases import ref_view, to_ref

KINDS = ("Node", "Pod", "ConfigMap")
PLURALS = {"Node": "nodes", "Pod": "pods", "ConfigMap": "configmaps"}


def wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.01)
    return False


# ------------------------------------------------------------ the servers


def _expiring_handler(base, server):
    """The reference server's handler, answering 410 Gone to a watch from
    a version the test expired (the port's server does so itself)."""

    class Handler(base):
        def do_GET(self):
            path, _, query = self.path.partition("?")
            params = dict(p.partition("=")[::2] for p in query.split("&") if p)
            since = int(params.get("resourceVersion") or 0)
            if params.get("watch") == "true" and since and since <= server.expired:
                return self._error(410, "Expired", f"too old resource version: {since}")
            return super().do_GET()

    return Handler


class Server:
    """One side's stub server, its wire helpers and version expiry."""

    def __init__(self, side):
        self.side = side
        if side == "port":
            self.api = tapiserver.StubApiServer()
        else:
            self.api = japiserver.StubApiServer()
            self.expired = 0
            self.api._server.RequestHandlerClass = _expiring_handler(
                self.api._server.RequestHandlerClass, self)
        self.api.start()

    def expire(self):
        """Versions up to now are gone: a watch resuming from one gets 410."""
        if self.side == "port":
            with self.api.state.lock:
                self.api.state.rv += 1  # a version with no event: nothing before it stays
            self.api.compact()
        else:
            with self.api.state.lock:
                self.api.state.rv += 1
                self.expired = self.api.state.rv - 1

    def objects(self):
        with self.api.state.lock:
            return {(PLURALS_TO_KIND[p], ns, name): o
                    for (p, ns, name), o in self.api.state.objects.items()
                    if p in PLURALS_TO_KIND}

    def stop(self):
        self.api.stop()


PLURALS_TO_KIND = {v: k for k, v in PLURALS.items()}


# ------------------------------------------------------------- the stores


class Store:
    """One side's KubeApiStore on a server, with a watch on it and a
    switch that drops every reflector's stream."""

    def __init__(self, side, server):
        self.side = side
        mod_client = tapiclient if side == "port" else japiclient
        mod_store = tapistore if side == "port" else japistore
        self.serde = tserde if side == "port" else jserde
        self.client = mod_client.KubeApiClient(mod_client.ClusterCredentials(
            server=server.api.url), timeout=5.0)
        self.drop = threading.Event()
        watch = self.client.watch

        def dropping_watch(path, rv="", stop=None, timeout_seconds=300):
            for event in watch(path, rv, stop, timeout_seconds):
                if self.drop.is_set():
                    return
                yield event

        self.client.watch = dropping_watch
        self.store = mod_store.KubeApiStore(self.client, kinds=KINDS, relist_backoff_s=0.2)
        self.store.start(sync_timeout_s=10.0)
        self.events = self.store.watch(list(KINDS), name="test")

    def obj(self, flat):
        return flat if self.side == "port" else to_ref(flat)

    def version(self, kind, name, ns=""):
        obj = self.store.try_get(kind, name, ns)
        return ref_view(obj)[3] if obj is not None else None

    def docs(self):
        """The cache as normalized wire documents."""
        out = {}
        for kind in KINDS:
            for obj in self.store.list(kind):
                doc = self.serde.to_wire(obj)
                doc["metadata"].pop("uid", None)
                doc["metadata"].pop("creationTimestamp", None)
                out[(kind, doc["metadata"].get("namespace", ""), doc["metadata"]["name"])] = doc
        return out

    def deliveries(self):
        out = []
        while not self.events.empty():
            e = self.events.get_nowait()
            out.append((e.type,) + ref_view(e.object))
        return out

    def stop(self):
        self.store.stop()


def _set(side, obj, field, value):
    """Set a flat field on either side's object."""
    if side == "port":
        if field in ("labels", "annotations"):
            getattr(obj, field).update(value)
        else:
            setattr(obj, field, value)
    elif field == "node":
        obj.spec.node_name = value
    elif field == "phase":
        obj.status.phase = value
    elif field in ("labels", "annotations"):
        getattr(obj.metadata, field).update(value)


def _labels(side, obj):
    return obj.labels if side == "port" else obj.metadata.labels


def scenario(store_side, server_side):
    server = Server(server_side)
    s = Store(store_side, server)
    try:
        st = s.store
        for i in range(2):
            st.create(s.obj(Node(f"n{i}", labels={"pool": "a"},
                                 capacity={"nvidia.com/gpu": 8, "memory": 2048},
                                 allocatable={"nvidia.com/gpu": 8, "memory": 2048})))
        for i in range(3):
            st.create(s.obj(Pod(f"p{i}", "ml", request={"nvidia.com/mig-3g.40gb": 1},
                                scheduler_name="nos-scheduler", labels={"app": "x"})))
        st.patch_merge("Pod", "p0", "ml", lambda p: _set(store_side, p, "node", "n0"))
        assert server.api.read("pods", "ml", "p0")["spec"]["nodeName"] == "n0"
        st.patch_merge("Pod", "p1", "ml", lambda p: _set(store_side, p, "phase", "Running"))
        st.patch_labels("Node", "n1", "", {"pool": "b", "zone": "z1"})
        st.create(s.obj(ConfigMap("lease", "nos-system", {"k": "v"})))

        # a merge patch whose first attempt loses to an outside writer
        attempts = []

        def contend(cm):
            attempts.append(1)
            if len(attempts) == 1:
                wire = server.api.read("configmaps", "nos-system", "lease")
                wire["metadata"].setdefault("annotations", {})["outside"] = "1"
                server.api.inject("configmaps", wire)
                rv = int(wire["metadata"]["resourceVersion"])
                assert wait_for(lambda: s.version("ConfigMap", "lease", "nos-system") == rv)
            _set(store_side, cm, "annotations", {"mine": "1"})

        st.patch_merge("ConfigMap", "lease", "nos-system", contend)
        assert len(attempts) == 2
        ann = server.api.read("configmaps", "nos-system", "lease")["metadata"]["annotations"]
        assert ann == {"outside": "1", "mine": "1"}

        # an outside create reaches the cache
        outside = tserde.to_wire(Pod("p9", "ml", scheduler_name="nos-scheduler"))
        rv = int(server.api.inject("pods", outside)["metadata"]["resourceVersion"])
        assert wait_for(lambda: s.version("Pod", "p9", "ml") == rv)

        # a stale update is refused, a fresh one taken
        stale = st.get("Pod", "p2", "ml")
        st.patch_labels("Pod", "p2", "ml", {"app": "y"})
        with pytest.raises((ConflictError, jstore.ConflictError)):
            st.update(stale, check_version=True)
        fresh = st.get("Pod", "p2", "ml")
        _labels(store_side, fresh)["team"] = "t"
        st.update(fresh, check_version=True)
        st.delete("Pod", "p1", "ml")
        with pytest.raises((NotFoundError, jstore.NotFoundError)):
            st.delete("Pod", "p1", "ml")

        # every stream drops, the server expires what they held, outside
        # writes land while they are down, and the reflectors relist
        s.drop.set()
        server.expire()
        node = server.api.read("nodes", "", "n0")
        node["metadata"]["labels"]["pool"] = "c"
        server.api.inject("nodes", node)
        server.api.inject("configmaps", tserde.to_wire(ConfigMap("late", "ml", {"a": "b"})))
        # a BOOKMARK a half second at most: each stream sees the switch
        time.sleep(0.8)
        s.drop.clear()
        want = server.objects()
        assert wait_for(lambda: s.docs().keys() == want.keys() and all(
            s.version(k, n, ns) == int(want[(k, ns, n)]["metadata"]["resourceVersion"])
            for k, ns, n in want))
        for key, doc in want.items():
            doc = dict(doc, kind=key[0])
            cached = st.get(key[0], key[2], key[1])
            assert s.serde.to_wire(cached) == s.serde.to_wire(s.serde.from_wire(doc))
        return s.docs(), s.deliveries()
    finally:
        s.stop()
        server.stop()


def test_four_store_and_server_combinations_agree():
    results = {(st, sv): scenario(st, sv)
               for st in ("port", "ref") for sv in ("port", "ref")}
    docs = {k: v[0] for k, v in results.items()}
    # a kind's deliveries come in its reflector's order; two kinds' may
    # interleave as their threads run
    deliveries = {k: sorted(v[1], key=lambda d: d[1]) for k, v in results.items()}
    base = ("ref", "ref")
    for combo in results:
        assert docs[combo] == docs[base], combo
        assert deliveries[combo] == deliveries[base], combo
    assert {d[0] for d in deliveries[base]} == {"ADDED", "MODIFIED", "DELETED"}
    assert len(docs[base]) == 7


# ------------------------------------------- the reference's own cases


@pytest.fixture(params=["port", "ref"])
def api(request):
    server = Server(request.param)
    yield server.api
    server.stop()


def _store(api, kinds=KINDS):
    client = tapiclient.KubeApiClient(tapiclient.ClusterCredentials(server=api.url),
                                      timeout=5.0)
    s = tapistore.KubeApiStore(client, kinds=kinds, relist_backoff_s=0.2)
    s.start(sync_timeout_s=10.0)
    return s


def test_reads_see_the_stores_own_writes_and_indexers_serve_the_cache(api):
    s = _store(api)
    try:
        s.add_indexer("Pod", "phase", lambda p: [p.phase])
        created = s.create(Pod("a", request={"nvidia.com/gpu": 1}))
        s.create(Pod("b"))
        assert s.get("Pod", "a", "default") == created and created.uid
        assert [p.name for p in s.list_by_index("Pod", "phase", "Pending")] == ["a", "b"]
        q = s.watch(["Pod"])
        s.patch_labels("Pod", "a", "default", {"x": "y"})
        events = [q.get(timeout=5) for _ in range(3)]
        assert [(e.type, e.object.name) for e in events] == [
            ("ADDED", "a"), ("ADDED", "b"), ("MODIFIED", "a")]
    finally:
        s.stop()


def test_a_noop_patch_writes_nothing_and_unmodelled_fields_survive(api):
    s = _store(api)
    try:
        wire = tserde.to_wire(Pod("rich"))
        wire["spec"]["serviceAccountName"] = "train-sa"
        wire["spec"]["volumes"] = [{"name": "data", "emptyDir": {}}]
        api.inject("pods", wire)
        assert wait_for(lambda: s.try_get("Pod", "rich", "default") is not None)
        before = api.read("pods", "default", "rich")["metadata"]["resourceVersion"]
        s.patch_merge("Pod", "rich", "default", lambda p: None)
        assert api.read("pods", "default", "rich")["metadata"]["resourceVersion"] == before
        s.patch_merge("Pod", "rich", "default", lambda p: p.annotations.update({"x": "y"}))
        after = api.read("pods", "default", "rich")
        assert after["spec"]["serviceAccountName"] == "train-sa"
        assert after["spec"]["volumes"] == [{"name": "data", "emptyDir": {}}]
        assert after["metadata"]["annotations"] == {"x": "y"}
    finally:
        s.stop()


def test_the_client_refuses_a_stale_put_and_streams_a_watch(api):
    client = tapiclient.KubeApiClient(tapiclient.ClusterCredentials(server=api.url),
                                      timeout=5.0)
    created = client.create("/api/v1/namespaces/default/configmaps",
                            {"kind": "ConfigMap", "metadata": {"name": "c"}, "data": {}})
    rv = created["metadata"]["resourceVersion"]
    client.replace("/api/v1/namespaces/default/configmaps/c", created)
    with pytest.raises(tapiclient.ApiError) as err:
        client.replace("/api/v1/namespaces/default/configmaps/c",
                       dict(created, metadata=dict(created["metadata"], resourceVersion=rv)))
    assert err.value.status == 409
    items, list_rv = client.list("/api/v1/configmaps")
    assert [i["metadata"]["name"] for i in items] == ["c"]
    stop = threading.Event()
    seen = []

    def watch():
        for event in client.watch("/api/v1/configmaps", list_rv, stop, timeout_seconds=5):
            if event["type"] != "BOOKMARK":
                seen.append(event["type"])
                stop.set()

    t = threading.Thread(target=watch)
    t.start()
    client.delete("/api/v1/namespaces/default/configmaps/c")
    t.join(10)
    assert seen == ["DELETED"] and not t.is_alive()


@pytest.mark.parametrize("side", ["port", "ref"])
def test_a_kind_the_server_does_not_serve_syncs_empty(side):
    module = tapiserver if side == "port" else japiserver
    api = module.StubApiServer(disabled_plurals={"elasticquotas"}).start()
    try:
        s = _store(api, kinds=("Pod", "ElasticQuota"))
        try:
            assert s.list("ElasticQuota") == []
            s.create(Pod("p1"))
            assert s.get("Pod", "p1", "default").name == "p1"
        finally:
            s.stop()
    finally:
        api.stop()


def test_a_watch_from_a_compacted_version_is_gone():
    api = tapiserver.StubApiServer().start()
    try:
        client = tapiclient.KubeApiClient(tapiclient.ClusterCredentials(server=api.url),
                                          timeout=5.0)
        client.create("/api/v1/nodes", {"kind": "Node", "metadata": {"name": "n"}})
        client.create("/api/v1/nodes", {"kind": "Node", "metadata": {"name": "m"}})
        api.compact(2)  # the log holds nothing at or below version 2
        with pytest.raises(tapiclient.ApiError) as err:
            next(client.watch("/api/v1/nodes", "1", timeout_seconds=2))
        assert err.value.status == 410
        client.create("/api/v1/nodes", {"kind": "Node", "metadata": {"name": "o"}})
        event = next(client.watch("/api/v1/nodes", "2", timeout_seconds=2))
        assert (event["type"], event["object"]["metadata"]["name"]) == ("ADDED", "o")
    finally:
        api.stop()


def test_a_kubeconfig_loads_as_the_reference_reads_it(tmp_path, monkeypatch):
    import base64

    path = tmp_path / "config"
    path.write_text(
        "current-context: smoke\n"
        "contexts:\n- name: smoke\n  context: {cluster: c, user: u}\n"
        "- name: other\n  context: {cluster: c, user: v}\n"
        "clusters:\n- name: c\n  cluster:\n"
        "    server: https://10.0.0.1:6443\n"
        f"    certificate-authority-data: {base64.b64encode(b'PEM').decode()}\n"
        "users:\n- name: u\n  user: {token: abc}\n"
        f"- name: v\n  user: {{tokenFile: {tmp_path / 'token'}}}\n")
    (tmp_path / "token").write_text("from-file\n")
    for context in (None, "other"):
        want = japiclient.load_kubeconfig(str(path), context)
        got = tapiclient.load_kubeconfig(str(path), context)
        assert vars(got) == vars(want)
    monkeypatch.setenv("KUBECONFIG", str(path))
    assert tapiclient.load_kubeconfig().token == "abc"
    with pytest.raises(ValueError):
        tapiclient.load_kubeconfig(str(path), "missing")
    monkeypatch.delenv("KUBERNETES_SERVICE_HOST", raising=False)
    with pytest.raises(RuntimeError):
        tapiclient.load_in_cluster()
    backoff = tapiclient.Backoff(base=0.1, cap=1.0, seed=7)
    ref = japiclient.Backoff(base=0.1, cap=1.0, seed=7)
    assert [backoff.next() for _ in range(6)] == [ref.next() for _ in range(6)]
