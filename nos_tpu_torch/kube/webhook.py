"""The admission webhook server: the TLS endpoint an API server calls.

Counterpart of ``nos_tpu/kube/webhook.py:86-269`` (reference
pkg/api/nos.nebuly.com/v1alpha1/elasticquota_webhook.go:31-97). The API
server POSTs AdmissionReview v1 documents; the server decodes the
object through ``kube/serde.py`` and runs the same validators the store's
admission seam runs (``controllers/elasticquota/webhooks.py``) against
the component's store: one validation, two transports. A validator that
raises ``AdmissionError`` denies with 403 and its message
(``WEBHOOK_DENIALS``); an object that does not decode denies with 400. A
mutator returns JSONPatch ops, sent base64-encoded; a mutator that fails
admits the pod unpatched (failurePolicy Ignore, as the reference).

TLS comes from ``cert_file`` / ``key_file`` (a mounted secret) through
the standard ``ssl`` module, or from PEM bytes; with neither, a
self-signed certificate is made by ``generate_self_signed_cert``, which
needs the ``cryptography`` package and imports it only when called.
"""
from __future__ import annotations

import base64
import json
import logging
import os
import ssl
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple

from nos_tpu_torch.kube import serde
from nos_tpu_torch.kube.store import AdmissionError, NodeStore
from nos_tpu_torch.util import metrics

log = logging.getLogger("nos_tpu_torch.webhook")

# the reference's paths: one a validated kind, and the pod mutator
PATH_ELASTICQUOTA = "/validate-nos-nebuly-com-v1alpha1-elasticquota"
PATH_COMPOSITEELASTICQUOTA = "/validate-nos-nebuly-com-v1alpha1-compositeelasticquota"
PATH_MUTATE_POD = "/mutate-v1-pod"


def generate_self_signed_cert(common_name: str = "nos-tpu-webhook",
                              sans: Tuple[str, ...] = ("localhost", "127.0.0.1"),
                              days: int = 365) -> Tuple[bytes, bytes]:
    """(cert PEM, key PEM) for local serving (``cryptography`` needed)."""
    import datetime
    import ipaddress

    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.x509.oid import NameOID
    except ImportError as e:
        raise RuntimeError("a self-signed certificate needs the 'cryptography' package; "
                           "give the webhook certFile and keyFile instead") from e

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    alt_names = []
    for san in sans:
        try:
            alt_names.append(x509.IPAddress(ipaddress.ip_address(san)))
        except ValueError:
            alt_names.append(x509.DNSName(san))
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder().subject_name(name).issuer_name(name)
            .public_key(key.public_key()).serial_number(x509.random_serial_number())
            .not_valid_before(now).not_valid_after(now + datetime.timedelta(days=days))
            .add_extension(x509.SubjectAlternativeName(alt_names), critical=False)
            .sign(key, hashes.SHA256()))
    return (cert.public_bytes(serialization.Encoding.PEM),
            key.private_bytes(serialization.Encoding.PEM,
                              serialization.PrivateFormat.TraditionalOpenSSL,
                              serialization.NoEncryption()))


def _review(uid: str, response: dict) -> dict:
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "response": {"uid": uid, **response}}


def review_validation(review: dict, validator: Callable, store: NodeStore) -> dict:
    """The AdmissionReview answer of ``validator(obj, store)``."""
    request = review.get("request") or {}
    uid = request.get("uid", "")
    try:
        validator(serde.from_wire(request.get("object") or {}), store)
        return _review(uid, {"allowed": True})
    except AdmissionError as e:
        metrics.WEBHOOK_DENIALS.inc()
        return _review(uid, {"allowed": False, "status": {"message": str(e), "code": 403}})
    except Exception as e:  # noqa: BLE001 - an undecodable object is denied
        metrics.WEBHOOK_DENIALS.inc()
        return _review(uid, {"allowed": False,
                             "status": {"message": f"webhook error: {e}", "code": 400}})


def review_mutation(review: dict, mutator: Callable, store: NodeStore) -> dict:
    """The AdmissionReview answer of ``mutator(wire, store)``'s JSONPatch."""
    request = review.get("request") or {}
    response: dict = {"allowed": True}
    try:
        ops = mutator(request.get("object") or {}, store)
        if ops:
            response["patchType"] = "JSONPatch"
            response["patch"] = base64.b64encode(json.dumps(ops).encode()).decode()
    except Exception as e:  # noqa: BLE001 - unrelated admissions go through
        log.warning("mutating webhook failed, admitting unpatched: %s", e)
    return _review(request.get("uid", ""), response)


class WebhookServer:
    """An HTTPS AdmissionReview endpoint bound to validators and mutators."""

    def __init__(self, store: NodeStore, port: int = 9443, host: str = "0.0.0.0",
                 cert_pem: Optional[bytes] = None, key_pem: Optional[bytes] = None,
                 cert_file: str = "", key_file: str = "") -> None:
        self.store = store
        self._validators: Dict[str, Callable] = {}
        self._mutators: Dict[str, Callable] = {}
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args) -> None:
                pass

            def do_POST(self) -> None:  # noqa: N802 (http.server's name)
                body = self.rfile.read(int(self.headers.get("Content-Length") or 0))
                path = self.path.partition("?")[0]
                validator = server._validators.get(path)
                mutator = server._mutators.get(path)
                if validator is None and mutator is None:
                    self._respond(404, {"message": f"no webhook at {path}"})
                    return
                try:
                    review = json.loads(body)
                    if mutator is not None:
                        answer = review_mutation(review, mutator, server.store)
                    else:
                        answer = review_validation(review, validator, server.store)
                except Exception as e:  # noqa: BLE001 - a malformed review
                    self._respond(400, {"message": f"bad AdmissionReview: {e}"})
                    return
                self._respond(200, answer)

            def _respond(self, code: int, payload: dict) -> None:
                data = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        if cert_file and key_file:
            ctx.load_cert_chain(cert_file, key_file)
        else:
            if cert_pem is None or key_pem is None:
                cert_pem, key_pem = generate_self_signed_cert()
                log.warning("webhook: serving a generated self-signed certificate "
                            "(give certFile and keyFile in production)")
            # ssl loads a chain only from files: a private directory for the load
            with tempfile.TemporaryDirectory(prefix="nos-tpu-torch-webhook-") as d:
                cert_path, key_path = os.path.join(d, "tls.crt"), os.path.join(d, "tls.key")
                with open(cert_path, "wb") as f:
                    f.write(cert_pem)
                with open(key_path, "wb") as f:
                    f.write(key_pem)
                ctx.load_cert_chain(cert_path, key_path)
        self._httpd.socket = ctx.wrap_socket(self._httpd.socket, server_side=True)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="webhook-server", daemon=True)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def register(self, path: str, validator: Callable) -> None:
        self._validators[path] = validator

    def register_mutator(self, path: str, mutator: Callable) -> None:
        self._mutators[path] = mutator

    def start(self) -> "WebhookServer":
        self._thread.start()
        log.info("webhook server listening on :%d (TLS)", self.port)
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=2.0)


def build_elasticquota_webhook_server(store: NodeStore, port: int = 9443,
                                      host: str = "0.0.0.0", cert_file: str = "",
                                      key_file: str = "", cert_pem: Optional[bytes] = None,
                                      key_pem: Optional[bytes] = None) -> WebhookServer:
    """The operator's webhook server: both quota validators, and the
    multi-node expansion at pod admission (the one point a real API
    server allows that rewrite)."""
    from nos_tpu_torch.controllers.elasticquota.webhooks import (
        validate_composite_elastic_quota,
        validate_elastic_quota,
    )
    from nos_tpu_torch.controllers.partitioner.multinode import admission_mutate_pod

    server = WebhookServer(store, port=port, host=host, cert_file=cert_file,
                           key_file=key_file, cert_pem=cert_pem, key_pem=key_pem)
    server.register(PATH_ELASTICQUOTA, validate_elastic_quota)
    server.register(PATH_COMPOSITEELASTICQUOTA, validate_composite_elastic_quota)
    server.register_mutator(PATH_MUTATE_POD, admission_mutate_pod)
    return server
