"""Self-signed TLS bootstrap for the kubelet API.

Reference parity: tryPrepareTlsCerts (cmd/slurm-virtual-kubelet/app/
server.go:351-382) — when the configured cert/key files do not exist, a
self-signed RSA certificate is generated in place so the kubelet HTTP
server always comes up with TLS. Same shape: 2048-bit RSA, one year,
serverAuth, 127.0.0.1 SAN, and the virtual node's name as a DNS SAN (an
improvement — the reference's cert carries no node identity).
"""

from __future__ import annotations

import datetime
import ipaddress
import logging
import os

log = logging.getLogger("sbt.certs")


def ensure_self_signed(
    cert_path: str, key_path: str, *, common_name: str = "sbt virtual kubelet"
) -> bool:
    """Generate cert/key at the given paths if neither exists.

    Returns True when usable files exist afterwards (pre-existing or
    freshly generated); False when generation failed.
    """
    if os.path.exists(cert_path) and os.path.exists(key_path):
        return True
    if os.path.exists(cert_path) != os.path.exists(key_path):
        log.warning("one of %s / %s exists without the other; not overwriting",
                    cert_path, key_path)
        return False
    try:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID
    except ImportError:
        # images without the cryptography wheel still carry the openssl
        # CLI — same cert shape, so the kubelet API keeps its TLS posture
        return _ensure_self_signed_openssl(cert_path, key_path, common_name)

    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    subject = x509.Name(
        [
            x509.NameAttribute(NameOID.ORGANIZATION_NAME, "kubecluster"),
            x509.NameAttribute(NameOID.ORGANIZATIONAL_UNIT_NAME, "sbj"),
            x509.NameAttribute(NameOID.COMMON_NAME, common_name),
        ]
    )
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (
        x509.CertificateBuilder()
        .subject_name(subject)
        .issuer_name(subject)
        .public_key(key.public_key())
        .serial_number(x509.random_serial_number())
        .not_valid_before(now)
        .not_valid_after(now + datetime.timedelta(days=365))
        .add_extension(
            x509.SubjectAlternativeName(
                [
                    x509.IPAddress(ipaddress.ip_address("127.0.0.1")),
                    x509.DNSName(common_name.replace(" ", "-")),
                ]
            ),
            critical=False,
        )
        .add_extension(
            x509.ExtendedKeyUsage([ExtendedKeyUsageOID.SERVER_AUTH]), critical=False
        )
        .sign(key, hashes.SHA256())
    )
    for path in (cert_path, key_path):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
    with open(key_path, "wb") as f:
        os.fchmod(f.fileno(), 0o600)
        f.write(
            key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.TraditionalOpenSSL,
                serialization.NoEncryption(),
            )
        )
    with open(cert_path, "wb") as f:
        f.write(cert.public_bytes(serialization.Encoding.PEM))
    log.info("generated self-signed TLS cert at %s", cert_path)
    return True


def _ensure_self_signed_openssl(
    cert_path: str, key_path: str, common_name: str
) -> bool:
    """openssl-CLI fallback with the same cert shape (2048-bit RSA, one
    year, serverAuth, 127.0.0.1 + node-name SANs)."""
    import shutil
    import subprocess

    openssl = shutil.which("openssl")
    if not openssl:
        log.warning(
            "neither cryptography nor the openssl CLI is available; "
            "cannot bootstrap TLS certs"
        )
        return False
    for path in (cert_path, key_path):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
    san = f"IP:127.0.0.1,DNS:{common_name.replace(' ', '-')}"
    try:
        subprocess.run(
            [
                openssl, "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                "-keyout", key_path, "-out", cert_path, "-days", "365",
                "-subj", f"/O=kubecluster/OU=sbj/CN={common_name}",
                "-addext", f"subjectAltName={san}",
                "-addext", "extendedKeyUsage=serverAuth",
            ],
            check=True,
            capture_output=True,
            timeout=60,
        )
    except (subprocess.SubprocessError, OSError) as exc:
        log.warning("openssl cert bootstrap failed: %s", exc)
        # ensure_self_signed only reaches generation when NEITHER file
        # existed, so anything present now is openssl's half-made output
        for path in (cert_path, key_path):
            if os.path.exists(path):
                os.unlink(path)
        return False
    os.chmod(key_path, 0o600)
    log.info("generated self-signed TLS cert at %s (openssl CLI)", cert_path)
    return True
