"""The paper's primary contribution: transparent pass-by-proxy data flow.

Public API::

    from repro_torch.core import Store, Proxy, StoreExecutor
    from repro_torch.core.connectors import ShardedConnector

    with Store("demo", ShardedConnector("/tmp/daos", num_shards=8)) as store:
        p = store.proxy(big_array)          # cheap wide-area reference
        future = client.submit(fn, p)       # scheduler never sees the bytes
"""

from repro_torch.core.executor import StoreExecutor
from repro_torch.core.ownership import (
    OwnedProxy,
    OwnershipError,
    RefMutProxy,
    RefProxy,
    borrow,
    mut_borrow,
    release,
    transfer,
)
from repro_torch.core.plugins import PluginRegistry, UnknownPluginError
from repro_torch.core.policy import (
    AllPolicy,
    AlwaysPolicy,
    AnyPolicy,
    NeverPolicy,
    SizePolicy,
    TypePolicy,
    list_policies,
    policy_from_config,
    register_policy,
)
from repro_torch.core.proxy import (
    Factory,
    LambdaFactory,
    Proxy,
    ProxyOr,
    ProxyResolveError,
    SimpleFactory,
    StoreFactory,
    TargetMetadata,
    extract,
    get_factory,
    get_metadata,
    is_proxy,
    is_resolved,
    proxy_token,
    resolve,
)
from repro_torch.core.serialize import (
    CopyCounter,
    FrameBundle,
    SerializedObject,
    deserialize,
    serialize,
)
from repro_torch.core.store import (
    Store,
    get_or_create_store,
    get_store,
    list_serializers,
    register_serializer,
    register_store,
    unregister_store,
)

__all__ = [
    "StoreExecutor",
    "OwnedProxy",
    "OwnershipError",
    "RefMutProxy",
    "RefProxy",
    "borrow",
    "mut_borrow",
    "release",
    "transfer",
    "AllPolicy",
    "AlwaysPolicy",
    "AnyPolicy",
    "NeverPolicy",
    "PluginRegistry",
    "SizePolicy",
    "TypePolicy",
    "UnknownPluginError",
    "list_policies",
    "policy_from_config",
    "register_policy",
    "Factory",
    "LambdaFactory",
    "Proxy",
    "ProxyOr",
    "ProxyResolveError",
    "SimpleFactory",
    "StoreFactory",
    "TargetMetadata",
    "extract",
    "get_factory",
    "get_metadata",
    "is_proxy",
    "is_resolved",
    "proxy_token",
    "resolve",
    "CopyCounter",
    "FrameBundle",
    "SerializedObject",
    "deserialize",
    "serialize",
    "Store",
    "get_or_create_store",
    "get_store",
    "list_serializers",
    "register_serializer",
    "register_store",
    "unregister_store",
]
