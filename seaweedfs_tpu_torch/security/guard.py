"""IP whitelist guard (reference `security/guard.go`): exact IPs, CIDR
prefixes, or "*" wildcard; empty whitelist = allow everyone."""

from __future__ import annotations

import ipaddress


class Guard:
    def __init__(self, whitelist: list[str] | None = None):
        self.networks: list[ipaddress._BaseNetwork] = []
        self.exact: set[str] = set()
        self.allow_all = not whitelist
        for item in whitelist or []:
            if item == "*":
                self.allow_all = True
            elif "/" in item:
                self.networks.append(ipaddress.ip_network(item, strict=False))
            else:
                self.exact.add(item)

    def allowed(self, ip: str) -> bool:
        if self.allow_all:
            return True
        if ip in self.exact:
            return True
        try:
            addr = ipaddress.ip_address(ip)
        except ValueError:
            return False
        return any(addr in net for net in self.networks)
