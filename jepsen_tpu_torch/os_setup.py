"""OS provisioning — the port's copy of :mod:`jepsen_tpu.os_setup`
(reference: jepsen/src/jepsen/os.clj:4-16 protocol; os/debian.clj,
os/centos.clj, os/ubuntu.clj, os/smartos.clj).

Sets up hostfiles, installs base packages, disables unattended upgrades —
the pre-DB groundwork each node needs.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

from . import control
from .control.util import meh


class OS:
    """(reference: os.clj:4-8)"""

    def setup(self, test: dict, node: Any) -> None:
        pass

    def teardown(self, test: dict, node: Any) -> None:
        pass


class NoopOS(OS):
    pass


noop = NoopOS()


def setup_hostfile(test: dict, node: Any) -> None:
    """Write /etc/hosts entries for every test node.
    (reference: os/debian.clj:13-26 setup-hostfile!)"""
    lines = ["127.0.0.1 localhost"]
    for n in test["nodes"]:
        try:
            from .net import node_ip

            ip = node_ip(n)
        except Exception:
            ip = str(n)
        lines.append(f"{ip} {n}")
    content = "\n".join(lines) + "\n"
    with control.su():
        from .control.util import write_file

        write_file(content, "/etc/hosts")


class Debian(OS):
    """(reference: os/debian.clj)"""

    def __init__(self, extra_packages: Iterable[str] = ()):
        self.extra_packages = list(extra_packages)

    base_packages = [
        "curl",
        "faketime",
        "iptables",
        "iputils-ping",
        "logrotate",
        "man-db",
        "net-tools",
        "ntpdate",
        "psmisc",
        "rsyslog",
        "sudo",
        "tar",
        "unzip",
        "wget",
    ]

    def setup(self, test, node):
        setup_hostfile(test, node)
        with control.su():
            # stop unattended upgrades from holding the dpkg lock
            meh(lambda: control.execute("systemctl", "stop", "unattended-upgrades", check=False))
            control.execute(
                "env", "DEBIAN_FRONTEND=noninteractive", "apt-get", "install",
                "-y", "--no-install-recommends",
                *(self.base_packages + self.extra_packages),
            )

    def install(self, packages: Iterable[str]) -> None:
        """(reference: os/debian.clj install)"""
        with control.su():
            control.execute(
                "env", "DEBIAN_FRONTEND=noninteractive", "apt-get", "install",
                "-y", "--no-install-recommends", *packages,
            )

    def installed_version(self, package: str) -> str:
        return control.execute(
            "dpkg-query", "-W", "-f", "${Version}", package
        )


debian = Debian()


class CentOS(OS):
    """(reference: os/centos.clj)"""

    base_packages = [
        "curl",
        "iptables",
        "iputils",
        "logrotate",
        "man-db",
        "net-tools",
        "ntpdate",
        "psmisc",
        "rsyslog",
        "sudo",
        "tar",
        "unzip",
        "wget",
    ]

    def setup(self, test, node):
        setup_hostfile(test, node)
        with control.su():
            control.execute("yum", "install", "-y", *self.base_packages)

    def install(self, packages: Iterable[str]) -> None:
        with control.su():
            control.execute("yum", "install", "-y", *packages)


centos = CentOS()


class Ubuntu(Debian):
    """Ubuntu = Debian + snapd/cloud-init quirks handled.
    (reference: os/ubuntu.clj:14-46)"""

    def setup(self, test, node):
        with control.su():
            meh(lambda: control.execute("systemctl", "stop", "snapd", check=False))
        super().setup(test, node)


ubuntu = Ubuntu()


class SmartOS(OS):
    """SmartOS (illumos) boxes: pkgin package management, svcadm-managed
    ipfilter, and a /etc/hosts loopback entry for the local hostname.
    (reference: os/smartos.clj)"""

    base_packages = [
        "wget",
        "curl",
        "vim",
        "unzip",
        "rsyslog",
        "logrotate",
    ]

    #: re-run `pkgin update` when the package DB is older than a day
    update_interval_s = 86_400

    def _setup_hostfile(self) -> None:
        """Append the local hostname to the 127.0.0.1 line if missing.
        (reference: smartos.clj:12-25 setup-hostfile!)"""
        import re as _re

        name = control.execute("hostname")
        hosts = control.execute("cat", "/etc/hosts")
        out = []
        for line in hosts.splitlines():
            # whole-token comparison: a hostname that happens to be a
            # substring of an alias must still be appended
            if _re.match(r"^127\.0\.0\.1\s", line) and name not in line.split():
                line = f"{line} {name}"
            out.append(line)
        with control.su():
            from .control.util import write_file

            write_file("\n".join(out) + "\n", "/etc/hosts")

    def _maybe_update(self) -> None:
        """pkgin update unless done recently.
        (reference: smartos.clj:27-43)"""
        try:
            now = int(control.execute("date", "+%s"))
            last = int(
                control.execute("stat", "-c", "%Y", "/var/db/pkgin/sql.log")
            )
            stale = self.update_interval_s < now - last
        except Exception:
            stale = True
        if stale:
            with control.su():
                control.execute("pkgin", "update")

    def installed(self, packages: Iterable[str]) -> set:
        """Subset of ``packages`` already installed, by pkgin list.
        (reference: smartos.clj:45-56 installed)"""
        return {str(p) for p in packages} & set(self._versions())

    def _versions(self) -> dict:
        """{package: installed version} from one pkgin list fetch."""
        out = {}
        for line in control.execute("pkgin", "-p", "list").splitlines():
            pkg = line.split(";", 1)[0]
            if "-" not in pkg:
                continue
            name, version = pkg.rsplit("-", 1)
            out[name] = version
        return out

    def installed_version(self, package: str) -> Optional[str]:
        """(reference: smartos.clj:72-84)"""
        return self._versions().get(str(package))

    def install(self, packages) -> None:
        """Install a collection of packages, or a {package: version}
        map.  (reference: smartos.clj:86-107)"""
        if isinstance(packages, dict):
            # one pkgin list fetch for all the version comparisons, not
            # one remote round-trip per package
            versions = self._versions()
            todo = [
                f"{pkg}-{version}"
                for pkg, version in packages.items()
                if versions.get(str(pkg)) != version
            ]
            if todo:
                with control.su():
                    control.execute("pkgin", "-y", "install", *todo)
            return
        missing = {str(p) for p in packages} - self.installed(packages)
        if missing:
            with control.su():
                control.execute("pkgin", "-y", "install", *sorted(missing))

    def uninstall(self, packages) -> None:
        """(reference: smartos.clj:58-63)"""
        pkgs = packages if isinstance(packages, (list, tuple, set)) else [packages]
        present = self.installed(pkgs)
        if present:
            with control.su():
                control.execute("pkgin", "-y", "remove", *sorted(present))

    def setup(self, test, node):
        self._setup_hostfile()
        self._maybe_update()
        self.install(self.base_packages)
        with control.su():
            control.execute("svcadm", "enable", "-r", "ipfilter")
        if test.get("net") is not None:
            meh(lambda: test["net"].heal(test))

    def teardown(self, test, node):
        pass


smartos = SmartOS()
